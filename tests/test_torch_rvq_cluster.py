"""RVQ encode #8's split over a thread-block cluster, on the CPU.

The kernel (``csrc/rvq.cu``) scores each stage's V codewords in C slices,
one a CTA, and merges the slices' bests in rank order (the higher score
wins, the lower index wins equal scores).  ``kernels.rvq.rvq_encode_split``
is the plain model of that merge: for C in 1, 2, 4, 8, 16 its codes equal
the plain version (``codec.rvq.rvq_encode``) and JAX's Pallas
``rvq_encode_fused`` (interpret mode, as ``tests/test_torch_codec.py`` runs
it) exactly, at the voice prompt's shape, a ragged batch and fewer stages,
and on codebooks with a codeword duplicated into another slice, where the
exact tie across CTAs must go to the lower index.  ``rvq_plan`` (the tile
and cluster the wrapper launches) is checked against the kernel's limits.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.kernels.rvq import rvq_encode_fused as j_rvq_encode_fused
from valle2_tpu_torch.codec import rvq as trvq
from valle2_tpu_torch.kernels import rvq as krvq

V, DIM = 1024, 128
CASES = {'prompt_1x150': (1, 150, 8), 'ragged_3x77': (3, 77, 4), 'tail_2x31': (2, 31, 2)}
# Stage q's duplicated codeword: index A[q] (the first slice at every C)
# copied to B[q] (another slice at every C > 1).
A = [5 + 3 * q for q in range(8)]
B = [600 + 41 * q for q in range(8)]


def codebooks(seed: int, duplicated: bool) -> np.ndarray:
    cb = np.random.RandomState(seed).uniform(-1, 1, (8, V, DIM)).astype(np.float32)
    if duplicated:
        cb *= (0.5 ** np.arange(8, dtype=np.float32))[:, None, None]
        cb[np.arange(8), B] = cb[np.arange(8), A]
    return cb


def latents(case: str, cb: np.ndarray, duplicated: bool) -> np.ndarray:
    b, t, _ = CASES[case]
    rs = np.random.RandomState(t)
    if not duplicated:
        return rs.standard_normal((b, t, DIM)).astype(np.float32)
    # every frame sits near the sum of the duplicated codewords, so each stage
    # ties between A[q] and B[q] exactly, the rest far behind
    base = cb[np.arange(8), A].sum(axis=0)
    return (base + 1e-4 * rs.standard_normal((b, t, DIM))).astype(np.float32)


_refs: dict = {}


def references(case: str, duplicated: bool):
    """(codebooks, latents, plain codes, JAX Pallas codes), computed once."""
    key = (case, duplicated)
    if key not in _refs:
        cb = codebooks(7, duplicated)
        lat = latents(case, cb, duplicated)
        n_q = CASES[case][2]
        plain = trvq.rvq_encode({'codebooks': torch.from_numpy(cb)}, torch.from_numpy(lat), n_q)
        pallas = np.asarray(j_rvq_encode_fused(jnp.asarray(cb), jnp.asarray(lat), n_q))
        _refs[key] = (cb, lat, plain, pallas)
    return _refs[key]


@pytest.mark.parametrize('cluster', krvq.CLUSTERS)
@pytest.mark.parametrize('duplicated', [False, True], ids=['random', 'tied'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_split_argmax_equals_plain_and_jax(case, duplicated, cluster):
    cb, lat, plain, pallas = references(case, duplicated)
    n_q = CASES[case][2]
    got = krvq.rvq_encode_split(torch.from_numpy(cb), torch.from_numpy(lat), n_q, cluster)
    assert got.dtype == torch.int32 and got.shape == plain.shape
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if duplicated:
        # the constructed ties are where the codes land: the lower index
        assert bool((got == torch.tensor(A[:n_q], dtype=torch.int32)[None, :, None]).all())


def test_split_refuses_a_cluster_that_does_not_divide_v():
    cb = torch.zeros(1, 96, DIM)
    with pytest.raises(ValueError, match='does not split'):
        krvq.rvq_encode_split(cb, torch.zeros(1, 2, DIM), cluster=64)


@pytest.mark.parametrize('rows,v,n_q', [(150, 1024, 8), (4800, 1024, 8), (231, 1024, 4),
                                        (1, 1024, 8), (62, 1024, 2), (150, 128, 8),
                                        (7200, 1024, 8), (300, 2048, 8)])
def test_plan_fits_the_kernel(rows, v, n_q):
    p = krvq.rvq_plan(rows, v, n_q, sms=132)
    frames, codes, tf, tj, lg = krvq.TILES[p['tile']]
    assert (p['frames'], p['codes'], p['thread']) == (frames, codes, (tf, tj, lg))
    assert p['cluster'] in krvq.CLUSTERS and v % (p['cluster'] * codes) == 0
    assert p['ctas'] == -(-rows // frames) * p['cluster']
    assert p['warps'] == krvq.tile_warps(p['tile']) == \
        frames // (lg * tf) * codes // (32 // lg * tj)
    assert p['smem'] == krvq.tile_smem(p['tile']) <= 227 * 1024


def test_tiles_are_whole_warps_and_fit_shared_memory():
    for tile, (frames, codes, tf, tj, lg) in enumerate(krvq.TILES):
        assert lg in (1, 2, 4, 8, 16, 32)
        assert frames % (lg * tf) == 0 and codes % (32 // lg * tj) == 0
        threads = 32 * krvq.tile_warps(tile)
        assert threads % codes == 0 and threads // codes <= 8      # |c|^2 threads a codeword
        assert krvq.tile_smem(tile) <= 227 * 1024


def test_plan_spreads_the_prompt_over_the_card():
    """A voice prompt (150 frames) reaches at least half the 132 SMs, where
    one CTA a 32-frame tile reached 5."""
    p = krvq.rvq_plan(150, 1024, 8, sms=132)
    assert p['cluster'] > 1 and p['ctas'] >= 66


def test_plan_without_a_tile_for_v_raises():
    with pytest.raises(ValueError, match='no tile divides'):
        krvq.rvq_plan(10, 96, 8, sms=132)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    cb, lat, plain, _ = references('tail_2x31', False)
    before = krvq.COUNTER.count
    got = krvq.rvq_encode_fused(torch.from_numpy(cb), torch.from_numpy(lat), 2)
    assert krvq.COUNTER.count == before and torch.equal(got, plain)
