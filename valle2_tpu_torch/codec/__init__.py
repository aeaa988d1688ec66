"""EnCodec (SEANet encoder and decoder + residual VQ) for PyTorch."""

from .convert import convert_state_dict, load_torch_checkpoint
from .encodec import (CODEBOOK_SIZE, HOP, LATENT_DIM, NUM_QUANTIZERS, SAMPLE_RATE,
                      Encodec, decode, embed, encode, init_params)
from .rvq import nearest_code, rvq_decode, rvq_encode, rvq_init

__all__ = ['CODEBOOK_SIZE', 'HOP', 'LATENT_DIM', 'NUM_QUANTIZERS', 'SAMPLE_RATE',
           'Encodec', 'convert_state_dict', 'decode', 'embed', 'encode', 'init_params',
           'load_torch_checkpoint', 'nearest_code', 'rvq_decode', 'rvq_encode', 'rvq_init']
