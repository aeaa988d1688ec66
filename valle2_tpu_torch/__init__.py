"""valle2_tpu_torch — the VALL-E X framework ported to PyTorch and CUDA (Hopper).

A second package beside the JAX one (``valle2_tpu``), which stays the
reference.  It imports neither JAX nor ``valle2_tpu``.  Ported so far: the TTS
serving path (``tts.ValleTTS``, voice cloning from a prompt recording) and
ASR (``tts.ValleASRPipeline``) with hand-written CUDA kernels for the AR
prefill (``kernels.flash_attention``), the AR token step
(``kernels.fused_decode``) and the codec's RVQ encode (``kernels.rvq``);
audio datasets tokenized through the codec (``data.ValleDataset``); and
training on one device (``train``) through the flash forward and backward
kernels; see ROADMAP.md for what remains.
"""

from .config import ConfigValle, bucket_len

__all__ = ['ConfigValle', 'bucket_len']
