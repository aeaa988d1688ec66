"""The port's audio utilities and codec encoder against the JAX package.

Resampling (atol 1e-5: the same taps, summed in another order), WAV bytes
(identical), strided causal convs (atol 1e-5), SEANet latents (within
1e-4 * max(1, |ref|)), RVQ codes (exact, against JAX ``rvq_encode`` and the
Pallas ``rvq_encode_fused`` in interpret mode), checkpoint conversion
(identical arrays) and full ``Encodec.encode`` codes on the weights of
``torch_encodec_mirror.EncodecMirror`` (exact, against the mirror and JAX
``EncodecTPU``).  The kernel itself is held against its plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_encodec_mirror import EncodecMirror
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import utils as jutils
from valle2_tpu.codec import EncodecTPU
from valle2_tpu.codec import conv as jconv
from valle2_tpu.codec import rvq as jrvq
from valle2_tpu.codec import seanet as jseanet
from valle2_tpu.codec.convert import convert_state_dict as j_convert_state_dict
from valle2_tpu.kernels.rvq import rvq_encode_fused as j_rvq_encode_fused
from valle2_tpu_torch import utils as tutils
from valle2_tpu_torch.codec import conv as tconv
from valle2_tpu_torch.codec import encodec as tenc
from valle2_tpu_torch.codec import rvq as trvq
from valle2_tpu_torch.codec import seanet as tseanet
from valle2_tpu_torch.codec.convert import convert_state_dict, load_torch_checkpoint
from valle2_tpu_torch.kernels import rvq as krvq
from valle2_tpu_torch.models.convert import codec_params_from_numpy


def peak_normalized(seed: int, samples: int) -> np.ndarray:
    wav = np.random.RandomState(seed).randn(samples).astype(np.float32)
    return wav / np.abs(wav).max()


@pytest.mark.parametrize('orig_sr', [16000, 22050, 48000])
def test_resample_matches_jax(orig_sr):
    x = np.random.RandomState(orig_sr).randn(2, 2 * orig_sr // 100).astype(np.float32)
    want = np.asarray(jutils.resample(jnp.asarray(x), orig_sr, 24000))
    got = tutils.resample(torch.from_numpy(x), orig_sr, 24000).numpy()
    assert got.shape == want.shape == (2, -(-x.shape[1] * 24000 // orig_sr))
    np.testing.assert_allclose(got, want, atol=1e-5)
    got_1d = tutils.resample(torch.from_numpy(x[1]), orig_sr, 24000)
    np.testing.assert_allclose(got_1d.numpy(), want[1], atol=1e-5)


def test_normalize_audio_stereo_matches_jax():
    x = np.random.RandomState(1).randn(2, 1500).astype(np.float32) * 3
    want = np.asarray(jutils.normalize_audio(jnp.asarray(x), 16000, 24000))
    got = tutils.normalize_audio(x, 16000, 24000).numpy()
    assert got.shape == want.shape == (2250,) and np.abs(got).max() == 1.0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wav_bytes_identical_to_jax(tmp_path):
    wav = np.random.RandomState(2).randn(999).astype(np.float32) * 0.7
    data = tutils.wav_pcm16_bytes(wav, 24000)
    assert data == jutils.wav_pcm16_bytes(wav, 24000)
    got, sr = tutils.wav_bytes_to_float(data)
    want, _ = jutils.wav_bytes_to_float(data)
    assert sr == 24000 and np.array_equal(got, want)
    tutils.save_wav(tmp_path / 'a.wav', wav, 24000)
    assert (tmp_path / 'a.wav').read_bytes() == data
    loaded = tutils.load_audio(tmp_path / 'a.wav', target_sr=24000, device='cpu')
    np.testing.assert_allclose(loaded.numpy(),
                               np.asarray(jutils.load_audio(tmp_path / 'a.wav', 24000)),
                               atol=1e-6)


@pytest.mark.parametrize('length', [319, 320, 321, 1600])
@pytest.mark.parametrize('stride', [2, 4, 5, 8])
def test_strided_causal_conv_matches_jax(stride, length):
    rs = np.random.RandomState(stride * 10000 + length)
    p = {'w': rs.randn(2 * stride, 4, 6).astype(np.float32) * 0.3,
         'b': rs.randn(6).astype(np.float32)}
    x = rs.randn(2, length, 4).astype(np.float32)
    want = np.asarray(jconv.causal_conv1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                          stride=stride))
    got = tconv.causal_conv1d({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), stride=stride).numpy()
    assert got.shape == want.shape == (2, -(-length // stride), 6)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_seanet_encode_matches_jax():
    jp = jseanet.encoder_init(jax.random.key(4))
    wav = np.stack([peak_normalized(5, 1600), peak_normalized(6, 1600)])
    want = np.asarray(jax.jit(jseanet.encode)(jp, jnp.asarray(wav)))
    got = tseanet.encode(codec_params_from_numpy(to_np(jp)), torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 5, 128)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize('n_q,b,t', [(8, 2, 300), (4, 1, 77)])
def test_rvq_encode_codes_equal_jax_and_pallas(n_q, b, t):
    p = jrvq.rvq_init(jax.random.key(n_q), num_quantizers=8, codebook_size=1024, dim=128)
    latents = np.random.RandomState(t).randn(b, t, 128).astype(np.float32)
    want = np.asarray(jrvq.rvq_encode(p, jnp.asarray(latents), n_q))
    pallas = np.asarray(j_rvq_encode_fused(p['codebooks'], jnp.asarray(latents), n_q))
    cb = torch.from_numpy(np.asarray(p['codebooks']))
    got = trvq.rvq_encode({'codebooks': cb}, torch.from_numpy(latents), n_q)
    assert got.dtype == torch.int32 and got.shape == (b, n_q, t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # The kernel's wrapper takes its plain version for CPU tensors.
    before = krvq.COUNTER.count
    np.testing.assert_array_equal(
        krvq.rvq_encode_fused(cb, torch.from_numpy(latents), n_q).numpy(), want)
    assert krvq.COUNTER.count == before
    # nearest_code on the first stage.
    np.testing.assert_array_equal(trvq.nearest_code(cb[0], torch.from_numpy(latents)).numpy(),
                                  np.asarray(jrvq.nearest_code(p['codebooks'][0],
                                                               jnp.asarray(latents))))


@pytest.fixture(scope='module')
def mirror_codecs():
    """The mirror (seed 0), its state dict converted by both packages, and
    the port's and JAX's codecs on those weights."""
    mirror = EncodecMirror(seed=0).eval()
    sd = mirror.numpy_state_dict()
    jp = j_convert_state_dict(sd)
    tp = convert_state_dict(sd)
    return (mirror, sd, jp, tp, EncodecTPU(params=jax.tree.map(jnp.asarray, jp)),
            tenc.Encodec(params=codec_params_from_numpy(tp), device='cpu'))


def test_convert_state_dict_identical_to_jax(mirror_codecs):
    _, _, jp, tp, _, _ = mirror_codecs
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = jax.tree_util.tree_flatten(tp)
    assert jdef == tdef and len(tl) == 89          # encoder 44, decoder 44, codebooks
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# 319: extra padding short of one hop; 320: one hop; 321: one sample into the
# second frame; 4800: 15 frames.  JAX encodes three of them (each length is a
# compile), the mirror all four.
@pytest.mark.parametrize('samples', [319, 320, 321, 4800])
def test_encodec_encode_codes_equal_mirror_and_jax(mirror_codecs, samples):
    mirror, _, _, _, jcodec, codec = mirror_codecs
    wav = peak_normalized(100, samples)
    got = codec.encode(wav)
    assert got.dtype == torch.int32 and got.shape == (8, -(-samples // 320))
    want = mirror.encode(torch.from_numpy(wav)[None])[0].numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    if samples != 320:
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcodec.encode(wav)))


def test_encodec_embedding_batch_and_fingerprint(mirror_codecs):
    mirror, _, _, _, jcodec, codec = mirror_codecs
    wavs = np.stack([peak_normalized(101, 4800), peak_normalized(102, 4800)])
    emb = codec.get_embedding(wavs[0])
    want = np.asarray(jcodec.get_embedding(wavs[0]))
    assert emb.shape == want.shape == (128, 15)
    np.testing.assert_allclose(emb.numpy(), want,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    batch = codec.batch_get_embedding(wavs)
    assert batch.shape == (2, 128, 15)
    np.testing.assert_allclose(batch[0].numpy(), emb.numpy(), atol=1e-6)
    codes = codec.batch_encode(wavs)
    np.testing.assert_array_equal(codes.numpy(),
                                  mirror.encode(torch.from_numpy(wavs)).numpy())
    assert codec.encode_decode(wavs[0]).shape == (4800,)
    assert codec.fingerprint() == jcodec.fingerprint()
    assert tenc.Encodec(seed=1, device='cpu').fingerprint() != codec.fingerprint()


def test_load_torch_checkpoint(mirror_codecs, tmp_path):
    mirror, sd, _, tp, _, codec = mirror_codecs
    path = tmp_path / 'encodec.th'
    torch.save({'best_state': mirror.state_dict()}, path)
    got = load_torch_checkpoint(str(path))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tp)):
        assert np.array_equal(a, b)
    torch.save(mirror.state_dict(), tmp_path / 'bare.pt')
    from_file = tenc.Encodec(checkpoint=str(tmp_path / 'bare.pt'), device='cpu')
    assert from_file.fingerprint() == codec.fingerprint()
    with pytest.raises(ValueError, match='OR checkpoint'):
        tenc.Encodec(params=codec.params, checkpoint=str(path), device='cpu')
