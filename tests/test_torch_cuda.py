"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA card, because the
kernels build with ``nvcc`` and run only there.  On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which these tests do not
use.)  ``chip_smoke.py`` holds the kernels at the main path's shapes; these
cover the rest of what the wrappers accept: every head dim, ragged and fully
masked rows, the bidirectional mask, both backward routes on both sides of
``FUSED_BWD_MAX_SEQ``, more rows than one projection block holds, the last
cache slot, a bfloat16 cache under a float32 model and a float32 cache under
a bfloat16 one (dense, int8 W8A8 and int4 W4A16), the quantized variants of
the fused step (int8 W8A8, int4 W4A16 with more than two scale groups, an
int8 cache, alone and combined) at every head dim, the speculative verify
step (#7) in all six variants with blocks of 1 to 9 tokens at distinct
per-row slots (one block ending at the last slot), the chunked cache of
both steps (the split over the cache and its merge) in every cache format
and head dim at chunks of 128 to 512 (the index in the first chunk, on a
boundary and at S - 1, a verify block straddling a boundary, 1 and 12
rows) and the refusal of a chunk that does not divide S, #6 with a per-row
index (continuous batching: every variant, head dim and dtype, whole-S and
chunked, rows at their own slots, one on a chunk boundary, one at S - 1 and
one frozen at S) and a joint greedy decode through it equal to the solo
decodes, both steps at the 204M
widths (d 1024, dff 4096: the 8-row projection tile), the 'auto' route of a
head dim no kernel takes, RVQ encode at frame counts that are not a multiple
of its 32-frame block, the codec's encode on the card against its CPU route
and under a caller's TF32 scope, the head-folded flash forward (#2) against
the plain version and bit for bit against #1 and itself at 1 to 16 heads,
with fewer and with more items than its persistent grid has slots, its
SASS (wgmma and TMA in bf16, no mma.sync), and the fold's grads against the
per-head route, the roofline probe's GEMMs (#9,
#10) at every tile and K split they are built for (#10 at one slice bit for
bit equal to #9, clusters of 5 to 8 slices, #9's persistent grid with more
and fewer tiles than SMs, #10's memory: C alone, and the SASS of both:
wgmma and TMA, no mma.sync), and the wrappers' refusals.  The persistent
#6 and #7 (each one cooperative launch a step) are held bit for bit against
the phased twin (``fused_verify_step_phased``; #6 as a block of one token)
in every weight x cache variant, whole-S and chunked, at the serving and
204M widths: #6 with a scalar and a per-row index, #7 with blocks of 2, 4
and 8 tokens (one straddling a chunk boundary, one ending at S - 1, one
whose last slots reach S and are skipped), and an int8 cache whose block
queries read the slots their block's earlier queries wrote; each is one
device kernel a launch and computes every row as that row alone; the bf16
CUDA-core routes of the flash forward and
backward, which ``chip_smoke.py`` times beside the tensor-core ones, are
held against the plain versions too.  The backward's tensor-core route
gives zero dq to rows that see no key; #4 and #5 repeat bit for bit from
call to call, and #3's dk, dv equal #5's bit for bit (one device body), also
at the register-tiled f32 kernels' edges (one row, a partial micro-tile,
one key past a tile, a causal lower bound inside a q tile); the
tensor-core route's bits are pinned by digest (``TC_BITS``).  The persistent
TP step (one cooperative launch per card a step, 5c's element in its reduce
phases) is held bit for bit against its phased twin
(``fused_step_tp_phased``) in every weight x cache x chunk x index case, #7
at K 2, 4 and 8, mp 2 and 4 virtual ranks, f32 and bf16, and over two real
cards (two launches of one rank, and two of two) where the host has them;
it is one device kernel a step, its grid is the plan's, W8A8 is refused,
and a wait across cards for a peer that never launches ends in an error
after about 10 s, in a process of its own.
"""

import math
import time

import numpy as np
import pytest
import torch

from valle2_tpu_torch import quantize as tq
from valle2_tpu_torch.config import ConfigValle, precision_scope
from valle2_tpu_torch.kernels import flash_attention as fa
from valle2_tpu_torch.kernels import fused_decode as fd
from valle2_tpu_torch.kernels import rvq as krvq
from valle2_tpu_torch.kernels import tp_allreduce as ta
from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init
from valle2_tpu_torch.parallel import make_model_mesh, shard_stack

pytestmark = pytest.mark.cuda

# Kernel against plain version: f32 sums in another order; in bf16 the plain
# versions round intermediates to bf16 where the kernels keep f32.
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
# The fused step with int8 W8A8 weights in f32: the kernel and the plain version
# compute the LayerNorm in other orders, so an activation x / sx that lands
# within rounding of a .5 boundary rounds to the neighbouring int8 code.  One
# such flip moves that row's outputs by one activation step, sx * max|w| ~
# (4 / 127) * (1 / sqrt(d)) <= 4e-3 at these widths, and every later
# projection of the row re-rounds about |shift| / sx of its activations, so
# the row's error walks on to ~10 steps (chip_smoke.py's TOL_QUANT); rows are
# independent, so only a few may leave the dense tolerance.  With dense weights
# and an int8 cache, a k/v code that flips moves y by up to ~5e-3, the JAX
# package's own tolerance for its int8-cache kernel (tests/test_kernels.py).
TOL_W8A8 = dict(atol=5e-2, rtol=0.0)
TOL_KV8 = dict(atol=5e-3, rtol=5e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels build with nvcc and run only there')
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        yield torch.device('cuda')


def assert_close(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


FLASH_CASES = {
    # (b, h, s, tokens_total, meta [tokens_valid, kv_end], causal)
    'ragged_causal': (2, 2, 100, 30, [[30, 100], [12, 77]], True),
    'bidirectional': (2, 2, 130, 40, [[40, 130], [25, 90]], False),
    'no_tokens': (1, 2, 70, 20, [[0, 70]], True),
    'slice_rows': (3, 4, 385, 128, [[112, 279], [97, 279], [81, 279]], True),
    'slice_bidirectional_no_tokens_row': (3, 4, 385, 128, [[112, 385], [0, 300], [81, 385]],
                                          False),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(dev, case, hd, dtype):
    b, h, s, tt, meta, causal = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, dtype) for _ in range(3))
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    before = fa.COUNTER.count
    o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
    assert fa.COUNTER.count == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    # The CUDA-core route that chip_smoke.py times beside the tensor cores'.
    o_cc, lse_cc = fa.flash_attention_cuda_cores(q, k, v, meta, tt, causal)
    assert_close(o_cc, o_ref, dtype)
    assert_close(lse_cc, lse_ref, torch.float32)


# The f32 forward's edges (its register-tiled route, q tiles of 128 rows):
# one row, a partial micro-tile, one key past a 64-key tile, and a q tile
# cut inside a causal range; each with a batch row of tokens_valid 0.
F32_EDGE_CASES = {
    's1': (2, 2, 1, 1, [[1, 1], [0, 1]], True),
    's17': (2, 2, 17, 5, [[5, 17], [0, 12]], True),
    'ragged_65': (2, 2, 65, 20, [[20, 65], [0, 64]], False),
    'mid_833': (2, 2, 833, 200, [[150, 833], [0, 601]], True),
}


def f32_train_inputs(dev, case):
    """chip_smoke.py's training shape ``case`` (probes.fwd_ablate.SHAPES,
    held equal to TRAIN_CASES on the CPU), f32, with its ragged meta."""
    from valle2_tpu_torch.probes import fwd_ablate
    b, tt, frames, causal = fwd_ablate.SHAPES[case]
    gen = torch.Generator().manual_seed(b + frames)
    q, k, v = (torch.randn(b, fwd_ablate.H, tt + frames, fwd_ablate.HD, generator=gen)
               .to(dev) for _ in range(3))
    return (q, k, v, fwd_ablate.train_meta(b, tt, frames, dev), tt, causal)


@pytest.mark.parametrize('case', ['ar', 'nar', 'ar_long'])
def test_flash_f32_kernel_at_the_training_shapes(dev, case):
    """The f32 forward (#1 on the CUDA cores) at chip_smoke.py's training
    shapes against the plain version, o and lse; a second call gives the
    same bits (no atomics, a fixed order per row)."""
    args = f32_train_inputs(dev, case)
    o, lse = fa.flash_attention(*args, fold_heads=False)
    o_ref, lse_ref = fa.flash_attention_plain(*args)
    assert_close(o, o_ref, torch.float32)
    assert_close(lse, lse_ref, torch.float32)
    o2, lse2 = fa.flash_attention(*args, fold_heads=False)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(F32_EDGE_CASES))
def test_flash_f32_kernel_at_ragged_lengths(dev, case, hd):
    """The f32 forward at ragged s (F32_EDGE_CASES) against the plain
    version, repeated bit for bit, and #2 bit-equal to it; the bf16
    CUDA-core route (the same body with bf16 operands) within bf16's
    tolerance."""
    b, h, s, tt, meta, causal = F32_EDGE_CASES[case]
    gen = torch.Generator().manual_seed(hd + s)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev) for _ in range(3))
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    args = (q, k, v, meta, tt, causal)
    o, lse = fa.flash_attention(*args, fold_heads=False)
    o_ref, lse_ref = fa.flash_attention_plain(*args)
    assert_close(o, o_ref, torch.float32)
    assert_close(lse, lse_ref, torch.float32)
    o2, lse2 = fa.flash_attention(*args, fold_heads=False)
    o_fold, lse_fold = fa.flash_attention_folded(*args)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, o_fold) and torch.equal(lse, lse_fold)
    b16 = [t.bfloat16() for t in (q, k, v)]
    o_cc, _ = fa.flash_attention_cuda_cores(*b16, meta, tt, causal)
    assert_close(o_cc, fa.flash_attention_plain(*b16, meta, tt, causal)[0], torch.bfloat16)


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'bidirectional'])
@pytest.mark.parametrize('hd', [32, 64, 128])
def test_flash_f32_rows_that_see_nothing_are_the_uniform_average(dev, hd, causal):
    """A batch row with tokens_valid == 0 whose rows see no key (causal: the
    token rows, before tokens_total; bidirectional with kv_end before
    tokens_total: every row) comes out, as in the plain version, as the
    average of v over all s keys, with lse the -1e30 sentinel plus log s."""
    b, h, s, tt = 2, 2, 300, 100
    gen = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev) for _ in range(3))
    meta = torch.tensor([[60, s], [0, s if causal else tt - 20]], dtype=torch.int32,
                        device=dev)
    o, lse = fa.flash_attention(q, k, v, meta, tt, causal, fold_heads=False)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
    assert_close(o, o_ref, torch.float32)
    assert_close(lse, lse_ref, torch.float32)
    rows = tt if causal else s
    assert_close(o[1, :, :rows], v[1].mean(dim=1, keepdim=True).expand(h, rows, hd),
                 torch.float32)
    assert torch.equal(lse[1, :, :rows],
                       torch.full_like(lse[1, :, :rows], -1e30 + math.log(s)))


def test_flash_wrappers_refuse_unaligned_inputs(dev):
    """#1 (both routes) and #2 stage q, k and v 16 bytes a thread: an f32 or
    bf16 view that does not start on a 16-byte boundary is refused with a
    ValueError, and nothing is launched."""
    meta = torch.tensor([[4, 16]], dtype=torch.int32, device=dev)
    counts = (fa.COUNTER.count, fa.FOLD_COUNTER.count, fa.CUDA_CORES_COUNTER.count)
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.randn(2 * 16 * 32 + 8, device=dev).to(dtype)
        aligned = flat[:2 * 16 * 32].view(1, 2, 16, 32)
        shifted = flat[1:2 * 16 * 32 + 1].view(1, 2, 16, 32)
        for args in ((shifted, aligned, aligned), (aligned, shifted, aligned),
                     (aligned, aligned, shifted)):
            for wrapper in (fa.flash_attention, fa.flash_attention_folded,
                            fa.flash_attention_cuda_cores):
                if wrapper is fa.flash_attention_cuda_cores and dtype == torch.float32:
                    continue
                with pytest.raises(ValueError, match='16-byte aligned'):
                    wrapper(*args, meta, 4)
    assert (fa.COUNTER.count, fa.FOLD_COUNTER.count, fa.CUDA_CORES_COUNTER.count) == counts


def test_flash_f32_sass_runs_cp_async_and_128_bit_shared_loads(dev):
    """The built flash_attention library's f32 forward kernels (#1's
    flash_fwd_cc_kernel<float, HD> and #2's flash_fold_cc_kernel<HD>, one
    per head dim) stage their tiles by cp.async (LDGSTS) and read them as
    float4 (LDS.128)."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from valle2_tpu_torch.kernels import _build
    _build.load('flash_attention')
    tool = shutil.which('cuobjdump') or str(Path(_build._nvcc()).with_name('cuobjdump'))
    sass = subprocess.run([tool, '-sass', str(_build._lib_path('flash_attention'))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    bodies = {}
    for part in re.split(r'\n\s*Function : ', sass)[1:]:
        name, _, body = part.partition('\n')
        bodies[name.strip()] = body
    found = [b for name, b in bodies.items()
             if 'flash_fwd_cc_kernelIf' in name or 'flash_fold_cc_kernel' in name]
    assert len(found) == 6, list(bodies)
    for body in found:
        assert re.search(r'\bLDGSTS\b', body)
        assert re.search(r'\bLDS\.128\b', body)


BWD_CASES = {
    # (b, h, s, tokens_total, meta [tokens_valid, kv_end], causal); s rounded up
    # to 128 decides the route: <= 768 the fused kernel, past it dq then dkv.
    'ragged_causal': (2, 2, 100, 30, [[30, 100], [12, 77]], True),
    'bidirectional': (2, 2, 130, 40, [[40, 130], [25, 90]], False),
    'no_tokens': (1, 2, 70, 20, [[0, 70]], True),
    'fused_edge_768': (1, 2, 768, 128, [[100, 700]], True),
    'split_causal_900': (2, 1, 900, 256, [[256, 900], [131, 555]], True),
    'split_bidirectional_777': (1, 2, 777, 128, [[90, 700]], False),
    # The CUDA-core kernels' tile and micro-tile edges: one row; one partial
    # micro-tile of rows and keys; one key past a 64-key tile, ragged; a
    # causal lower bound that starts inside a q tile (tokens_valid 150, 77).
    's1': (1, 2, 1, 1, [[1, 1]], True),
    's17': (2, 2, 17, 5, [[5, 17], [3, 12]], True),
    'ragged_65': (2, 2, 65, 20, [[20, 65], [7, 64]], False),
    'split_causal_mid_833': (2, 2, 833, 200, [[150, 833], [77, 601]], True),
}
# The cases at s <= FUSED_BWD_MAX_SEQ (rounded up to 128), which the fused #3 takes.
FUSED_BWD_CASES = ('ragged_causal', 'bidirectional', 'no_tokens', 'fused_edge_768', 's1',
                   's17', 'ragged_65')


def bwd_inputs(dev, case, hd, dtype):
    b, h, s, tt, meta, causal = BWD_CASES[case]
    gen = torch.Generator().manual_seed(hd + s)
    q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(dev, dtype) for _ in range(4))
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
    return (q, k, v, meta, o, lse, do), tt, causal


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(BWD_CASES))
def test_flash_bwd_kernels_match_plain(dev, case, hd, dtype):
    """Both backward routes (fused #3; dq #4 + dkv #5) against the plain
    backward, and the router picks the JAX package's route for s.  The fused
    kernel's dq sums through atomics in a varying order; f32 sums in another
    order: the f32 tolerance covers both."""
    args, tt, causal = bwd_inputs(dev, case, hd, dtype)
    want = fa.flash_attention_bwd_plain(*args, tt, causal)
    counts = [c.count for c in (fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER)]
    routed = fa.flash_attention_bwd(*args, tt, causal)
    fused = fa.uses_fused_bwd(args[0].shape[2])
    assert fused == (case in FUSED_BWD_CASES)
    assert [c.count for c in (fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER,
                              fa.BWD_DKV_COUNTER)] == [counts[0] + fused,
                                                      counts[1] + (not fused),
                                                      counts[2] + (not fused)]
    one_pass = fa.flash_bwd_fused(*args, tt, causal)
    split = (fa.flash_bwd_dq(*args, tt, causal), *fa.flash_bwd_dkv(*args, tt, causal))
    for got in (routed, one_pass, split):
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert_close(g, w, dtype)


@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(BWD_CASES))
def test_flash_bwd_cuda_core_route_matches_plain(dev, case, hd):
    """The bf16 CUDA-core route, which chip_smoke.py times beside the tensor
    cores', follows the same router and matches the plain backward under the
    same tolerance; its launches count apart from the main path's."""
    args, tt, causal = bwd_inputs(dev, case, hd, torch.bfloat16)
    want = fa.flash_attention_bwd_plain(*args, tt, causal)
    main = (fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER)
    before, cc = [c.count for c in main], fa.BWD_CUDA_CORES_COUNTER.count
    got = fa.flash_attention_bwd_cuda_cores(*args, tt, causal)
    assert [c.count for c in main] == before
    assert fa.BWD_CUDA_CORES_COUNTER.count == cc + (1 if fa.uses_fused_bwd(args[0].shape[2])
                                                    else 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert_close(g, w, torch.bfloat16)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', ['ragged_causal', 'split_causal_900', 's17',
                                  'split_causal_mid_833'])
def test_flash_bwd_split_kernels_repeat_bit_for_bit(dev, case, hd, dtype):
    """#4 and #5 sum in a fixed order (no atomics): the same inputs give the
    same bits from call to call."""
    args, tt, causal = bwd_inputs(dev, case, hd, dtype)
    first = (fa.flash_bwd_dq(*args, tt, causal), *fa.flash_bwd_dkv(*args, tt, causal))
    second = (fa.flash_bwd_dq(*args, tt, causal), *fa.flash_bwd_dkv(*args, tt, causal))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', FUSED_BWD_CASES)
def test_fused_bwd_dk_dv_equal_the_dkv_kernel(dev, case, hd, dtype):
    """#3 and #5 run one device body over the q tiles in one order (only #3's
    dq goes through atomics), so at s <= 768 #3's dk, dv equal #5's bit for
    bit."""
    args, tt, causal = bwd_inputs(dev, case, hd, dtype)
    _, dk, dv = fa.flash_bwd_fused(*args, tt, causal)
    dk_split, dv_split = fa.flash_bwd_dkv(*args, tt, causal)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk_split) and torch.equal(dv, dv_split)


def test_flash_bwd_fully_masked_rows_get_zero_grad(dev):
    """tokens_valid = 0: token rows see no key, so their dq is exactly 0 and
    they add nothing to dk, dv (the Pallas kernels' rule)."""
    args, tt, causal = bwd_inputs(dev, 'no_tokens', 32, torch.float32)
    for dq in (fa.flash_bwd_fused(*args, tt, causal)[0], fa.flash_bwd_dq(*args, tt, causal)):
        torch.cuda.synchronize()
        assert float(dq[:, :, :tt].abs().max()) == 0.0


@pytest.mark.parametrize('hd', [32, 64, 128])
def test_flash_bwd_tensor_core_route_zero_grad_for_rows_that_see_nothing(dev, hd):
    """The bf16 tensor-core route masks p to exactly 0 per accumulator
    element, so token rows that see no key (tokens_valid = 0) get dq == 0 on
    both routes, whatever their lse."""
    args, tt, causal = bwd_inputs(dev, 'no_tokens', hd, torch.bfloat16)
    for dq in (fa.flash_bwd_fused(*args, tt, causal)[0], fa.flash_bwd_dq(*args, tt, causal)):
        torch.cuda.synchronize()
        assert float(dq[:, :, :tt].abs().max()) == 0.0
        assert float(dq[:, :, tt:].abs().max()) > 0.0


# The bf16 tensor-core backward on fixed inputs (numpy, seed 7 + hd, rounded
# to bf16; lse and delta computed in float64 on the CPU and passed in, so
# that no PyTorch reduction on the card enters): sha256 of the output bytes
# of #3's dk, dv, #4's dq and #5's dk, dv, as the parent of the f32
# CUDA-core redesign built them (#3's dq sums through atomics in a varying
# order and is left out).
TC_BITS_CASE = (2, 2, 200, 40, [[40, 200], [25, 150]], True)
TC_BITS = {
    32: {'dk3': '0b18c785d401c91e', 'dv3': '62ef18b73e2e245f',
         'dq4': '7f178d2c4d34bdb4', 'dk5': '0b18c785d401c91e',
         'dv5': '62ef18b73e2e245f'},
    64: {'dk3': 'f0bdaa21a76dae01', 'dv3': 'ebe8ed812d19c98a',
         'dq4': '87ef38405edcfe2e', 'dk5': 'f0bdaa21a76dae01',
         'dv5': 'ebe8ed812d19c98a'},
    128: {'dk3': 'ee7f35fdc5c677c2', 'dv3': '0485439c7ecc9650',
          'dq4': 'da35656f7980f5cd', 'dk5': 'ee7f35fdc5c677c2',
          'dv5': '0485439c7ecc9650'},
}


def tc_route_bits(dev, hd) -> dict:
    """{output: sha256 prefix} of the bf16 tensor-core backward on
    TC_BITS_CASE at head dim hd."""
    import hashlib
    import math

    from valle2_tpu_torch.ops.masks import prefix_lm_attend
    b, h, s, tt, meta, causal = TC_BITS_CASE
    rs = np.random.RandomState(7 + hd)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((b, h, s, hd)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    meta = torch.tensor(meta, dtype=torch.int32)
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    scores = torch.matmul(qd, kd.transpose(-1, -2)) / math.sqrt(hd)
    attend = prefix_lm_attend(s, tt, meta[:, 0], meta[:, 1], causal)[:, None]
    scores = torch.where(attend, scores, -1e30)
    lse = torch.logsumexp(scores, -1)
    o = torch.matmul(torch.softmax(scores, -1), vd)
    delta = (dod * o).sum(-1)
    args = [t.to(dev) for t in (q, k, v, meta, o.to(torch.bfloat16), lse.float())] + [do.to(dev)]
    kw = dict(delta=delta.float().to(dev))
    _, dk3, dv3 = fa.flash_bwd_fused(*args, tt, causal, **kw)
    dq4 = fa.flash_bwd_dq(*args, tt, causal, **kw)
    dk5, dv5 = fa.flash_bwd_dkv(*args, tt, causal, **kw)
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
            for name, t in (('dk3', dk3), ('dv3', dv3), ('dq4', dq4), ('dk5', dk5),
                            ('dv5', dv5))}


@pytest.mark.parametrize('hd', [32, 64, 128])
def test_flash_bwd_tensor_core_route_bits_unchanged(dev, hd):
    """The bf16 tensor-core route gives the bits its build gave before the
    f32 CUDA-core kernels were redesigned beside it (TC_BITS)."""
    assert tc_route_bits(dev, hd) == TC_BITS[hd]


def test_flash_function_grads_match_plain_route(dev):
    """FlashAttention.apply on the card: grads through the kernels == grads
    through the plain backward of the same forward."""
    args, tt, causal = bwd_inputs(dev, 'ragged_causal', 64, torch.float32)
    with torch.inference_mode(False), torch.enable_grad():
        q, k, v, meta, do = (a.clone() for a in (*args[:4], args[6]))
        q, k, v = (a.requires_grad_() for a in (q, k, v))
        o = fa.FlashAttention.apply(q, k, v, meta, tt, causal)
        o.backward(do)
    o_ref, lse_ref = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(), meta, tt,
                                              causal)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), meta, o_ref,
                                        lse_ref, do, tt, causal)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert_close(g, w, torch.float32)


@pytest.mark.parametrize('frames', [96, 1024], ids=['fused_s128', 'split_s1280'])
def test_full_width_ar_step_matches_plain_route(dev, frames):
    """One full-width AR train step (f32, TF32 off) through the kernels: its
    loss and every grad equal those of the plain bias route, and the step
    launches the forward and the backward route for its s."""
    import dataclasses

    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.train import init_state, make_train_step, tree_leaves
    cfg = ConfigValle(dropout=0.0, matmul_precision='highest', use_flash_attention=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False)
    rs = np.random.RandomState(frames)
    tt = frames // 4
    batch = {'tokens': rs.randint(0, 256, (2, tt)), 'tokens_lens': np.asarray([tt, tt - 5]),
             'codes': rs.randint(0, 1026, (2, frames)),
             'codes_lens': np.asarray([frames, frames - 17]),
             'target': rs.randint(0, 1025, (2, frames))}
    with torch.inference_mode(False):
        batch = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in batch.items()}
        state = init_state(cfg, 'ValleAR', device=dev)
        leaves = tree_leaves(state.params)
        got = {}
        for name, c in (('kernels', cfg), ('plain', plain)):
            with precision_scope(c):
                loss, _ = ar_mod.loss_fn(state.params, c, batch)
                got[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
        (lk, gk), (lp, gp) = got['kernels'], got['plain']
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
        for a, w in zip(gk, gp):   # per leaf, relative to its largest |grad|
            assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
        counters = (fa.COUNTER, fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER)
        before = [c.count for c in counters]
        state, metrics = make_train_step(cfg, 'ValleAR')(state, batch, 0)
        torch.cuda.synchronize()
    fused = fa.uses_fused_bwd(tt + frames)
    assert [c.count - n for c, n in zip(counters, before)] == [
        cfg.num_layers, cfg.num_layers * fused, cfg.num_layers * (not fused),
        cfg.num_layers * (not fused)]
    torch.testing.assert_close(metrics['loss'], lk, rtol=1e-5, atol=0)
    assert state.opt_state.count == 1


def fused_inputs(dev, dtype, cache_dtype, hd, rows, L=2, h=2, ttm=24, pm=16, max_new=12):
    d = h * hd
    gen = torch.Generator().manual_seed(rows + hd)
    p = transformer_init(gen, L, d, h, 4 * d, adaptive_norm=False)
    p = map_tree(lambda a: a.to(dev, dtype).contiguous(), p)
    S = ttm + pm + max_new
    ck, cv = (torch.randn(L, rows, S, d, generator=gen).to(dev, cache_dtype)
              for _ in range(2))
    x = torch.randn(rows, 1, d, generator=gen).to(dev, dtype)
    rs = np.random.RandomState(rows)
    tl = rs.randint(0, ttm + 1, rows)
    tl[0] = 0                                   # a row with no source tokens
    cl = rs.randint(1, pm + 1, rows)
    lens = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (tl, cl)]
    return p, x, ck, cv, lens, ttm, pm


@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=['f32', 'f32_bf16cache', 'bf16', 'bf16_f32cache'])
@pytest.mark.parametrize('hd', [32, 64, 96, 128])
@pytest.mark.parametrize('rows', [5, 20], ids=['first_slot', 'last_slot_two_row_blocks'])
def test_fused_step_kernel_matches_plain(dev, rows, hd, dtypes):
    dtype, cache_dtype = dtypes
    p, x, ck, cv, (tl, cl), ttm, pm = fused_inputs(dev, dtype, cache_dtype, hd, rows)
    S = ck.shape[2]
    index = ttm + pm if rows == 5 else S - 1
    c_k, c_p = KVCache(ck.clone(), cv.clone()), KVCache(ck.clone(), cv.clone())
    before = fd.COUNTER.count
    y, out = fd.fused_decode_step(p, x, 2, c_k, index, tl, cl, ttm, pm)
    assert fd.COUNTER.count == before + 1 and out.k is c_k.k
    y_ref, _ = fd.fused_decode_step_plain(p, x, 2, c_p, index, tl, cl, ttm, pm)
    loose = torch.bfloat16 if torch.bfloat16 in dtypes else torch.float32
    assert_close(y, y_ref, loose)
    assert_close(c_k.k, c_p.k, loose)
    assert_close(c_k.v, c_p.v, loose)
    # Only slot `index` was written.
    untouched = torch.ones(S, dtype=torch.bool)
    untouched[index] = False
    assert torch.equal(c_k.k[:, :, untouched], ck[:, :, untouched])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 2, 16, 48, device=dev)
    meta = torch.tensor([[4, 16]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='head dims'):
        fa.flash_attention(q, q, q, meta, 4)
    q = torch.randn(1, 2, 16, 32, device=dev)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fa.flash_attention(q.half(), q.half(), q.half(), meta, 4)
    with pytest.raises(ValueError, match='contiguous'):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        fa.flash_attention(t, t, t, meta, 4)
    o, lse = fa.flash_attention(q, q, q, meta, 4)
    for wrapper in (fa.flash_bwd_fused, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            h = q.half()
            wrapper(h, h, h, meta, o.half(), lse, h, 4)
        with pytest.raises(ValueError, match='head dims'):
            w = torch.randn(1, 2, 16, 48, device=dev)
            wrapper(w, w, w, meta, w, lse, w, 4)
        with pytest.raises(ValueError, match='lse'):
            wrapper(q, q, q, meta, o, lse.double(), q, 4)
        with pytest.raises(ValueError, match='match in shape'):
            wrapper(q, q, q, meta, o, lse, q[:, :, :8].contiguous(), 4)
        with pytest.raises(ValueError, match='contiguous'):
            t = q.transpose(2, 3).contiguous().transpose(2, 3)
            wrapper(q, q, q, meta, o, lse, t, 4)
        with pytest.raises(ValueError, match='meta'):
            wrapper(q, q, q, meta.long(), o, lse, q, 4)
    p, x, ck, cv, (tl, cl), ttm, pm = fused_inputs(dev, torch.bfloat16, torch.float32, 32, 3)
    with pytest.raises(ValueError, match='outside'):
        fd.fused_decode_step(p, x, 2, KVCache(ck.bfloat16(), cv.bfloat16()), ttm + pm - 1,
                             tl, cl, ttm, pm)


QUANT_VARIANTS = ('w8a8', 'w4a16', 'kv8', 'w8a8_kv8', 'w4a16_kv8')


def quant_inputs(dev, variant, dtype, hd, rows, L=2, h=2, ttm=24, pm=16, max_new=12):
    """A stack of ``variant`` (dff = 8d: int4 has four or more scale groups
    over the FFN's hidden input) and a cache of its format."""
    d = h * hd
    gen = torch.Generator().manual_seed(rows + hd)
    p = transformer_init(gen, L, d, h, 8 * d, adaptive_norm=False)
    if variant.startswith(('w8a8', 'w4a16')):
        p = tq.quantize_transformer(p, bits=8 if variant.startswith('w8a8') else 4)
    p = map_tree(lambda a: (a.to(dtype) if a.is_floating_point() else a).to(dev)
                 .contiguous(), p)
    S = ttm + pm + max_new
    ck, cv = (torch.randn(L, rows, S, d, generator=gen) for _ in range(2))
    if variant.endswith('kv8'):
        (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, h) for c in (ck, cv))
        cache = [t.to(dev) for t in (kq, vq, ks, vs)]
    else:
        cache = [c.to(dev, dtype) for c in (ck, cv)]
    x = torch.randn(rows, 1, d, generator=gen).to(dev, dtype)
    rs = np.random.RandomState(rows)
    tl = rs.randint(0, ttm + 1, rows)
    tl[0] = 0
    cl = rs.randint(1, pm + 1, rows)
    lens = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (tl, cl)]
    return p, x, cache, lens, ttm, pm


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 96, 128])
@pytest.mark.parametrize('rows', [5, 20], ids=['first_slot', 'last_slot_two_row_blocks'])
@pytest.mark.parametrize('variant', QUANT_VARIANTS)
def test_fused_step_quant_kernel_matches_plain(dev, variant, rows, hd, dtype):
    """Each #6a variant against the plain version on the same codes: y within
    its tolerance, int8 cache codes within one step (bf16 scales within a
    bf16 step) and only slot ``index`` written."""
    p, x, cache, (tl, cl), ttm, pm = quant_inputs(dev, variant, dtype, hd, rows)
    S = cache[0].shape[2]
    index = ttm + pm if rows == 5 else S - 1
    c_k, c_p = KVCache(*(c.clone() for c in cache)), KVCache(*(c.clone() for c in cache))
    counter = fd.COUNTERS[variant]
    before = counter.count
    y, out = fd.fused_decode_step(p, x, 2, c_k, index, tl, cl, ttm, pm)
    assert counter.count == before + 1 and out.k is c_k.k
    y_ref, _ = fd.fused_decode_step_plain(p, x, 2, c_p, index, tl, cl, ttm, pm)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    if dtype == torch.bfloat16:
        tol = TOL[dtype]
    else:
        tol = TOL_W8A8 if variant.startswith('w8a8') else (
            TOL_KV8 if variant.endswith('kv8') else TOL[dtype])
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    if variant.startswith('w8a8') and dtype == torch.float32:
        rows_off = (y - y_ref).abs().amax(dim=(1, 2)) > TOL[dtype]['atol']
        assert int(rows_off.sum()) <= max(2, rows // 4)
    untouched = torch.ones(S, dtype=torch.bool)
    untouched[index] = False
    for got, want, orig in zip(c_k, c_p, cache):
        assert torch.equal(got[:, :, untouched], orig[:, :, untouched])
    if variant in ('kv8', 'w4a16_kv8') and dtype == torch.float32:
        for got, want in zip(c_k[:2], c_p[:2]):       # codes within one step
            diff = (got.int() - want.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
        for got, want in zip(c_k[2:], c_p[2:]):       # bf16 of an f32 amax / 127
            torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=2 ** -7)
    else:   # bf16, or a W8A8 row that flipped: the new slot's k/v differ as y does
        for got, want in zip(dequant(c_k), dequant(c_p)):
            torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize('hd', [32, 64, 96, 128])
@pytest.mark.parametrize('variant', ['w8a8', 'w4a16'])
def test_fused_step_quant_weights_take_an_f32_cache_under_a_bf16_model(dev, variant, hd):
    """#6a under a bfloat16 model with a float32 cache (the JAX kernel reads
    its cache in float32 whatever the model's dtype) against the plain
    version: y and the written slot within the bfloat16 tolerance, the
    other slots untouched, the variant's launch counted once."""
    p, x, cache, (tl, cl), ttm, pm = quant_inputs(dev, variant, torch.bfloat16, hd, 20)
    cache = [c.float() for c in cache]
    S = cache[0].shape[2]
    index = S - 1
    c_k, c_p = KVCache(*(c.clone() for c in cache)), KVCache(*(c.clone() for c in cache))
    counter = fd.COUNTERS[variant]
    before = counter.count
    y, out = fd.fused_decode_step(p, x, 2, c_k, index, tl, cl, ttm, pm)
    assert counter.count == before + 1 and out.k is c_k.k and out.k.dtype == torch.float32
    y_ref, _ = fd.fused_decode_step_plain(p, x, 2, c_p, index, tl, cl, ttm, pm)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL[torch.bfloat16])
    for got, want, orig in zip(c_k, c_p, cache):
        assert torch.equal(got[:, :, :index], orig[:, :, :index])
        torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


def dequant(cache):
    """The (L, rows, S, d) f32 values of a fused cache, int8 or float."""
    if cache.k_scale is None:
        return cache.k.float(), cache.v.float()
    view = fd.per_head_view(cache, 2)
    return tuple((c.float() * s.float()).permute(0, 1, 3, 2, 4).flatten(-2)
                 for c, s in ((view.k, view.k_scale), (view.v, view.v_scale)))


def test_fused_step_refuses_what_the_quant_kernel_does_not_take(dev):
    p, x, cache, (tl, cl), ttm, pm = quant_inputs(dev, 'w4a16_kv8', torch.bfloat16, 32, 3)
    kq, vq, ks, vs = cache
    with pytest.raises(ValueError, match='int8 cache scale'):
        fd.fused_decode_step(p, x, 2, KVCache(kq, vq), ttm + pm, tl, cl, ttm, pm)
    with pytest.raises(ValueError, match='int8 cache scale'):
        fd.fused_decode_step(p, x, 2, KVCache(kq, vq, ks.float(), vs), ttm + pm, tl, cl,
                             ttm, pm)
    with pytest.raises(ValueError, match='int8 cache scale'):
        fd.fused_decode_step(p, x, 2, KVCache(kq, vq, ks[:, :, :-1].contiguous(), vs),
                             ttm + pm, tl, cl, ttm, pm)
    dense = KVCache(kq.bfloat16(), vq.bfloat16())
    with pytest.raises(ValueError, match='int8 cache only'):
        fd.fused_decode_step(p, x, 2, KVCache(dense.k, dense.v, ks, vs), ttm + pm, tl, cl,
                             ttm, pm)
    wide = map_tree(lambda a: a, p)
    wide['ffn']['lin2'] = dict(p['ffn']['lin2'], q4=torch.cat([p['ffn']['lin2']['q4']] * 2,
                                                               dim=1))
    with pytest.raises(ValueError, match="'q4' weight"):
        fd.fused_decode_step(wide, x, 2, dense, ttm + pm, tl, cl, ttm, pm)
    fp32_scales = map_tree(lambda a: a, p)
    fp32_scales['attn']['qkv'] = dict(p['attn']['qkv'],
                                      scale4=p['attn']['qkv']['scale4'].float())
    with pytest.raises(ValueError, match='group scale'):
        fd.fused_decode_step(fp32_scales, x, 2, dense, ttm + pm, tl, cl, ttm, pm)
    mixed = map_tree(lambda a: a, p)
    mixed['ffn']['lin1'] = tq.quantize_linear(tq.dequantize_linear_int4(p['ffn']['lin1']))
    with pytest.raises(ValueError, match='layout'):
        fd.fused_decode_step(mixed, x, 2, dense, ttm + pm, tl, cl, ttm, pm)


VERIFY_VARIANTS = ('dense',) + QUANT_VARIANTS
# (K, rows): blocks of one token, of 4 (12 query rows, one projection tile)
# and of 9 (27 query rows over two tiles; two query groups in the attention)
VERIFY_BLOCKS = [(1, 5), (4, 3), (9, 1), (9, 3)]


def verify_inputs(dev, variant, dtype, hd, rows, K, L=2, h=2, ttm=24, pm=16, max_new=12):
    """A stack and cache of ``variant`` (quant_inputs) with a (rows, K, d)
    block and distinct per-row start slots, the last row's block ending at
    slot S - 1."""
    if variant == 'dense':
        p, _, ck, cv, lens, ttm, pm = fused_inputs(dev, dtype, dtype, hd, rows, L, h, ttm, pm,
                                                   max_new + K)
        cache = [ck, cv]
    else:
        p, _, cache, lens, ttm, pm = quant_inputs(dev, variant, dtype, hd, rows, L, h, ttm, pm,
                                                  max_new + K)
    S = cache[0].shape[2]
    gen = torch.Generator().manual_seed(100 * K + rows)
    x = torch.randn(rows, K, h * hd, generator=gen).to(dev, dtype)
    starts = [ttm + pm + (5 * r) % max_new for r in range(rows - 1)] + [S - K]
    index = torch.tensor(starts, dtype=torch.int32, device=dev)
    return p, x, cache, lens, ttm, pm, index


def written_slots(index, K, S):
    """(rows, S) bool: the slots a verify block writes."""
    slots = torch.arange(S, device=index.device)[None, :]
    return (slots >= index[:, None]) & (slots < index[:, None] + K)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 96, 128])
@pytest.mark.parametrize('K,rows', VERIFY_BLOCKS, ids=[f'K{k}_rows{r}' for k, r in
                                                       VERIFY_BLOCKS])
@pytest.mark.parametrize('variant', VERIFY_VARIANTS)
def test_fused_verify_kernel_matches_plain(dev, variant, K, rows, hd, dtype):
    """#7 against fused_verify_step_plain: y within the variant's tolerance,
    every written cache slot as the plain version writes it (int8 codes
    within one step on under 1% in f32), every other slot untouched, and the
    variant's launch counted once."""
    p, x, cache, (tl, cl), ttm, pm, index = verify_inputs(dev, variant, dtype, hd, rows, K)
    S = cache[0].shape[2]
    c_k, c_p = KVCache(*(c.clone() for c in cache)), KVCache(*(c.clone() for c in cache))
    counter = fd.VERIFY_COUNTERS[variant]
    before = counter.count
    y, out = fd.fused_verify_step(p, x, 2, c_k, index, tl, cl, ttm, pm)
    assert counter.count == before + 1 and out.k is c_k.k and y.shape == x.shape
    y_ref, _ = fd.fused_verify_step_plain(p, x, 2, c_p, index, tl, cl, ttm, pm)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    if dtype == torch.bfloat16:
        tol = TOL[dtype]
    else:
        tol = TOL_W8A8 if variant.startswith('w8a8') else (
            TOL_KV8 if variant.endswith('kv8') else TOL[dtype])
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    written = written_slots(index, K, S)
    for got, orig in zip(c_k, cache):
        assert torch.equal(got[:, ~written], orig[:, ~written])
    if variant in ('kv8', 'w4a16_kv8') and dtype == torch.float32:
        for got, want in zip(c_k[:2], c_p[:2]):
            diff = (got[:, written].int() - want[:, written].int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
        for got, want in zip(c_k[2:], c_p[2:]):
            torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=2 ** -7)
    else:
        for got, want in zip(dequant(c_k), dequant(c_p)):
            torch.testing.assert_close(got, want, **tol)


# The chunked cache: (model dtype, cache dtype) of each cache format.
CHUNK_CACHES = {'f32': (torch.float32, torch.float32), 'bf16': (torch.bfloat16, torch.bfloat16),
                'int8': (torch.float32, torch.int8),
                'bf16_f32cache': (torch.bfloat16, torch.float32)}
CHUNK_TOL = {'f32': TOL[torch.float32], 'bf16': TOL[torch.bfloat16], 'int8': TOL_KV8,
             'bf16_f32cache': TOL[torch.bfloat16]}


def chunked_inputs(dev, cache_name, hd, rows, S, K, L=2, h=2, ttm=24, pm=16):
    """A dense stack, a (L, rows, S, d) cache in ``cache_name``'s format, a
    (rows, K, d) block and per-row lengths (row 0 with no source tokens)."""
    dtype, cache_dtype = CHUNK_CACHES[cache_name]
    d = h * hd
    gen = torch.Generator().manual_seed(S + rows + hd)
    p = transformer_init(gen, L, d, h, 4 * d, adaptive_norm=False)
    p = map_tree(lambda a: a.to(dev, dtype).contiguous(), p)
    ck, cv = (torch.randn(L, rows, S, d, generator=gen) for _ in range(2))
    if cache_dtype == torch.int8:
        (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, h) for c in (ck, cv))
        cache = [t.to(dev) for t in (kq, vq, ks, vs)]
    else:
        cache = [c.to(dev, cache_dtype) for c in (ck, cv)]
    x = torch.randn(rows, K, d, generator=gen).to(dev, dtype)
    rs = np.random.RandomState(rows + hd)
    tl = rs.randint(0, ttm + 1, rows)
    tl[0] = 0
    cl = rs.randint(1, pm + 1, rows)
    lens = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (tl, cl)]
    return p, x, cache, lens, ttm, pm


def assert_same_cache(got, want, cache_name):
    """Kernel cache against the plain version's: int8 codes within one step
    on under 1% (bf16 scales within one bf16 step), float slots within the
    format's tolerance."""
    if cache_name == 'int8':
        for g, w in zip(got[:2], want[:2]):
            diff = (g.int() - w.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
        for g, w in zip(got[2:], want[2:]):
            torch.testing.assert_close(g.float(), w.float(), atol=0, rtol=2 ** -7)
    else:
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g.float(), w.float(), **CHUNK_TOL[cache_name])


@pytest.mark.parametrize('chunk', [128, 256, 512])
@pytest.mark.parametrize('hd', [32, 64, 96, 128])
@pytest.mark.parametrize('cache_name', sorted(CHUNK_CACHES))
def test_chunked_steps_match_plain(dev, cache_name, hd, chunk):
    """#6 and #7 with the cache split into chunks (S = 1024) against their
    plain versions (the online softmax over the chunks): #6 with its index
    in the first chunk, on a chunk boundary and at S - 1; #7 with blocks of
    4 tokens, one straddling a chunk boundary and one ending at S - 1; at 1
    and 12 rows.  Each launch counts once in its variant's counter and once
    in the chunked one."""
    S, K = 1024, 4
    tol = CHUNK_TOL[cache_name]
    for rows in (1, 12):
        p, x, cache, (tl, cl), ttm, pm = chunked_inputs(dev, cache_name, hd, rows, S, K)
        variant = 'kv8' if cache_name == 'int8' else 'dense'
        starts = [chunk - 2, S - K, ttm + pm, chunk + 1] * 3
        steps = [(fd.fused_decode_step, fd.fused_decode_step_plain, x[:, :1].contiguous(),
                  index, fd.COUNTERS[variant]) for index in (ttm + pm + 5, chunk, S - 1)]
        steps.append((fd.fused_verify_step, fd.fused_verify_step_plain, x,
                      torch.tensor(starts[:rows], dtype=torch.int32, device=dev),
                      fd.VERIFY_COUNTERS[variant]))
        for kernel, plain, xq, index, counter in steps:
            c_k, c_p = (KVCache(*(c.clone() for c in cache)) for _ in range(2))
            chunked = fd.CHUNKED_COUNTERS[kernel.__name__]
            before = (counter.count, chunked.count)
            y, _ = kernel(p, xq, 2, c_k, index, tl, cl, ttm, pm, chunk_override=chunk)
            assert (counter.count, chunked.count) == (before[0] + 1, before[1] + 1)
            y_ref, _ = plain(p, xq, 2, c_p, index, tl, cl, ttm, pm, chunk_override=chunk)
            torch.cuda.synchronize()
            assert torch.isfinite(y).all()
            torch.testing.assert_close(y.float(), y_ref.float(), **tol)
            assert_same_cache(c_k, c_p, cache_name)


# #6 with a per-row index (continuous batching): rows at their own slots of
# S = 512 -- the first generated slot, both sides of the chunk boundary at
# 128, two deep ones, S - 2, S - 1, and one row frozen at S.
def per_row_index(ttm, pm, S, dev):
    return torch.tensor([ttm + pm, 127, 128, 200, 300, S - 2, S - 1, S], dtype=torch.int32,
                        device=dev)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 96, 128])
@pytest.mark.parametrize('chunk', [None, 128], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('variant', VERIFY_VARIANTS)
def test_per_row_decode_kernel_matches_plain(dev, variant, chunk, hd, dtype):
    """#6 with a (rows,) index against fused_decode_step_plain with the same
    tensor: y within the variant's tolerance, each row's own slot written as
    the plain version writes it, every other slot untouched (the row at S
    writes nothing), and the launch counted in the variant's counter, the
    per-row one and, below S, the chunked ones."""
    p, x, cache, (tl, cl), ttm, pm = quant_inputs(dev, variant, dtype, hd, 8, max_new=472)
    S = cache[0].shape[2]
    index = per_row_index(ttm, pm, S, dev)
    c_k, c_p = KVCache(*(c.clone() for c in cache)), KVCache(*(c.clone() for c in cache))
    counters = (fd.COUNTERS[variant], fd.PER_ROW_COUNTERS['fused_decode_step_per_row'],
                fd.PER_ROW_COUNTERS['fused_decode_step_per_row_chunked'],
                fd.CHUNKED_COUNTERS['fused_decode_step'])
    before = [c.count for c in counters]
    y, out = fd.fused_decode_step(p, x, 2, c_k, index, tl, cl, ttm, pm, chunk_override=chunk)
    assert [c.count - b for c, b in zip(counters, before)] == [1, 1] + [int(bool(chunk))] * 2
    assert out.k is c_k.k
    y_ref, _ = fd.fused_decode_step_plain(p, x, 2, c_p, index, tl, cl, ttm, pm,
                                          chunk_override=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    if dtype == torch.bfloat16:
        tol = TOL[dtype]
    else:
        tol = TOL_W8A8 if variant.startswith('w8a8') else (
            TOL_KV8 if variant.endswith('kv8') else TOL[dtype])
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    if variant.startswith('w8a8') and dtype == torch.float32:
        rows_off = (y - y_ref).abs().amax(dim=(1, 2)) > TOL[dtype]['atol']
        assert int(rows_off.sum()) <= 2
    written = written_slots(index, 1, S)
    assert not written[-1].any()
    for got, orig in zip(c_k, cache):
        assert torch.equal(got[:, ~written], orig[:, ~written])
    if variant in ('kv8', 'w4a16_kv8') and dtype == torch.float32:
        for got, want in zip(c_k[:2], c_p[:2]):
            diff = (got[:, written].int() - want[:, written].int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
        for got, want in zip(c_k[2:], c_p[2:]):
            torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=2 ** -7)
    else:
        for got, want in zip(dequant(c_k), dequant(c_p)):
            torch.testing.assert_close(got, want, **tol)


def test_per_row_wrapper_refuses_what_the_kernel_does_not_take(dev):
    p, x, cache, (tl, cl), ttm, pm = quant_inputs(dev, 'dense', torch.float32, 32, 8,
                                                  max_new=472)
    c = KVCache(*cache)
    index = per_row_index(ttm, pm, cache[0].shape[2], dev)
    for bad in (index.long(), index[:4].contiguous(), index.cpu()):
        with pytest.raises(ValueError, match='start slots'):
            fd.fused_decode_step(p, x, 2, c, bad, tl, cl, ttm, pm)


def test_fused_step_scratch_outlives_its_launch_beside_another_thread(dev):
    """A stream hub's driver steps while a join's prefill allocates on another
    thread.  The step's scratch must stay allocated until its kernels are
    queued: freed before (and the launch releases the GIL), the other thread
    takes the memory and its writes and the step's land in one buffer.  A
    second thread allocates and fills buffers of the scratch's sizes while
    this one steps: every step equals the first, every buffer holds its fill."""
    import threading
    p, x, ck, cv, (tl, cl), ttm, pm = fused_inputs(dev, torch.float32, torch.float32, 64, 20)
    rows, d, dff = x.shape[0], x.shape[2], 4 * x.shape[2]

    def step():
        return fd.fused_decode_step(p, x, 2, KVCache(ck.clone(), cv.clone()), ttm + pm, tl,
                                    cl, ttm, pm)[0]
    want = step()
    torch.cuda.synchronize()
    stop, clobbered = threading.Event(), []

    def allocate():
        while not stop.is_set():
            bufs = [torch.full((rows, n), 7.0, device=dev) for n in (d, d, d, dff)]
            clobbered.extend(i for i, b in enumerate(bufs) if not bool((b == 7.0).all()))
    other = threading.Thread(target=allocate)
    other.start()
    try:
        differ = sum(not torch.equal(step(), want) for _ in range(300))
    finally:
        stop.set()
        other.join()
    assert differ == 0 and not clobbered


@pytest.mark.parametrize('wdtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_decode_logits_do_not_depend_on_the_row_count(dev, wdtype):
    """The decode loops' logits head gives a row the same bits alone as among
    4 or 12 rows, under TF32 (the default precision) too: a joint decode
    samples each row as its solo decode does."""
    from valle2_tpu_torch.config import tf32_scope
    from valle2_tpu_torch.ops import decode_logits, linear_init
    gen = torch.Generator().manual_seed(11)
    p = {k: v.to(dev, wdtype) for k, v in linear_init(gen, 256, 1025).items()}
    y = torch.randn(12, 256, generator=gen).to(dev)
    with tf32_scope(True):
        full = decode_logits(p, y)
        assert full.dtype == torch.float32
        for rows in (1, 4):
            for r in range(rows):
                assert torch.equal(decode_logits(p, y[r:rows]), full[r:rows])


@pytest.mark.parametrize('decode_chunk', [0, 32], ids=['whole_s', 'chunked'])
def test_joint_greedy_decode_through_the_kernels_equals_solo(dev, decode_chunk):
    """ContinuousDecoder on the card (f32, TF32 off): three sessions on two
    rows, one joining mid-flight and one reusing a released row, decode the
    greedy ids of their solo DecodeStreams; every joint step launched the
    per-row #6 (below S its chunked branch), no plain version."""
    from valle2_tpu_torch.models import ValleAR
    from valle2_tpu_torch.models.ar import DecodeStream
    from valle2_tpu_torch.models.continuous import ContinuousDecoder
    cfg = ConfigValle(d_model=128, n_heads=2, dim_feedforward=256, num_layers=2,
                      max_audio_len=40, num_beams=1, temperature=0.0, ignore_eos=True,
                      kv_cache_dtype='float32', matmul_precision='highest',
                      bucket_sizes=(32, 64, 128), decode_chunk=decode_chunk)
    model = ValleAR(cfg, device='cuda')
    rs = np.random.RandomState(3)
    prompts = [(rs.randint(0, 70, (rs.randint(4, 20),)),
                rs.randint(0, 1024, (rs.randint(3, 20), 8))) for _ in range(3)]
    want = [DecodeStream(model, t, c).advance(10 ** 4) for t, c in prompts]
    per_row = fd.PER_ROW_COUNTERS['fused_decode_step_per_row']
    chunked = fd.PER_ROW_COUNTERS['fused_decode_step_per_row_chunked']
    before = (per_row.count, chunked.count, fd.PLAIN_CALLS.count)
    cb = ContinuousDecoder(model, n_slots=2)
    got = [[], [], []]
    s0 = cb.join(*prompts[0])
    got[0].extend(cb.advance(7).get(s0, []))
    s1 = cb.join(*prompts[1])
    while not cb.finished(s0):
        out = cb.advance(6)
        got[0].extend(out.get(s0, []))
        got[1].extend(out.get(s1, []))
    cb.release(s0)
    s2 = cb.join(*prompts[2])
    while not (cb.finished(s1) and cb.finished(s2)):
        out = cb.advance(6)
        got[1].extend(out.get(s1, []))
        got[2].extend(out.get(s2, []))
    steps = per_row.count - before[0]
    assert steps >= 2 * cfg.max_audio_len and fd.PLAIN_CALLS.count == before[2]
    assert chunked.count - before[1] == (steps if decode_chunk else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_chunk_must_divide_the_cache(dev):
    """A chunk that does not divide S is refused by both kernels and both
    plain versions; a chunk >= S takes the whole-S kernel (no chunked
    launch)."""
    p, x, cache, (tl, cl), ttm, pm = chunked_inputs(dev, 'f32', 32, 2, 1000, 4)
    index = torch.tensor([ttm + pm, 900], dtype=torch.int32, device=dev)
    c = KVCache(*cache)
    for kernel in (fd.fused_decode_step, fd.fused_decode_step_plain):
        with pytest.raises(ValueError, match='multiple'):
            kernel(p, x[:, :1].contiguous(), 2, c, ttm + pm, tl, cl, ttm, pm,
                   chunk_override=256)
    for kernel in (fd.fused_verify_step, fd.fused_verify_step_plain):
        with pytest.raises(ValueError, match='multiple'):
            kernel(p, x, 2, c, index, tl, cl, ttm, pm, chunk_override=256)
    before = fd.CHUNKED_COUNTERS['fused_decode_step'].count
    fd.fused_decode_step(p, x[:, :1].contiguous(), 2, c, ttm + pm, tl, cl, ttm, pm,
                         chunk_override=1000)
    torch.cuda.synchronize()
    assert fd.CHUNKED_COUNTERS['fused_decode_step'].count == before


@pytest.mark.parametrize('variant', ['dense', 'w8a8'])
def test_wide_stack_steps_match_plain(dev, variant):
    """The 204M widths (d 1024, 16 heads, dff 4096): FFN2's 4096-wide input
    takes the 8-row projection tile.  #6 at 12 rows (two 8-row tiles) and #7
    at 3 rows x 4 tokens against their plain versions, f32 with TF32 off."""
    d, h, dff, L, ttm, pm, max_new = 1024, 16, 4096, 2, 24, 16, 16
    gen = torch.Generator().manual_seed(7)
    p = transformer_init(gen, L, d, h, dff, adaptive_norm=False)
    if variant == 'w8a8':
        p = tq.quantize_transformer(p, bits=8)
    p = map_tree(lambda a: a.to(dev).contiguous(), p)
    assert fd.fit_error(d, h, dff, fd.weight_format(p)) is None
    S = ttm + pm + max_new
    tol = TOL_W8A8 if variant == 'w8a8' else TOL[torch.float32]
    for rows, K in ((12, 1), (3, 4)):
        ck, cv = (torch.randn(L, rows, S, d, generator=gen).to(dev) for _ in range(2))
        x = torch.randn(rows, K, d, generator=gen).to(dev)
        tl = torch.full((rows,), 20, dtype=torch.int32, device=dev)
        cl = torch.full((rows,), 9, dtype=torch.int32, device=dev)
        c_k, c_p = KVCache(ck.clone(), cv.clone()), KVCache(ck.clone(), cv.clone())
        if K == 1:
            y, _ = fd.fused_decode_step(p, x, h, c_k, ttm + pm + 3, tl, cl, ttm, pm)
            y_ref, _ = fd.fused_decode_step_plain(p, x, h, c_p, ttm + pm + 3, tl, cl, ttm, pm)
        else:
            index = torch.tensor([ttm + pm, ttm + pm + 7, S - K], dtype=torch.int32,
                                 device=dev)
            y, _ = fd.fused_verify_step(p, x, h, c_k, index, tl, cl, ttm, pm)
            y_ref, _ = fd.fused_verify_step_plain(p, x, h, c_p, index, tl, cl, ttm, pm)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        torch.testing.assert_close(y, y_ref, **tol)
        torch.testing.assert_close(c_k.k, c_p.k, **tol)
        torch.testing.assert_close(c_k.v, c_p.v, **tol)


# The persistent #6 and #7 (one cooperative launch a step) against the
# phased twin on the same inputs: fused_verify_step_phased (for #6 with a
# block of one token and the same start slots) runs the phased kernels, whose
# device code every item of the persistent step runs, so the two agree bit
# for bit.  Widths (h, hd): the serving model's (d 256) and the 204M stack's
# (d 1024, dff 4096: FFN2 takes the 8-row tile), in a cache of S = 128,
# whole or chunked (64).
PERSISTENT_WIDTHS = {'serving': (4, 64), 'w204m': (16, 64)}


def persistent_inputs(dev, variant, dtype, widths, rows=8, L=2, ttm=24, pm=16, S=128, K=1):
    """A stack and fused cache of ``variant``, a (rows, K, d) block and
    per-row lengths (row 0 with no source tokens)."""
    h, hd = PERSISTENT_WIDTHS[widths]
    d = h * hd
    gen = torch.Generator().manual_seed(d + rows)
    p = transformer_init(gen, L, d, h, 4 * d, adaptive_norm=False)
    if variant.startswith(('w8a8', 'w4a16')):
        p = tq.quantize_transformer(p, bits=8 if variant.startswith('w8a8') else 4)
    p = map_tree(lambda a: (a.to(dtype) if a.is_floating_point() else a).to(dev)
                 .contiguous(), p)
    ck, cv = (torch.randn(L, rows, S, d, generator=gen) for _ in range(2))
    if variant.endswith('kv8'):
        (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, h) for c in (ck, cv))
        cache = KVCache(*(t.to(dev) for t in (kq, vq, ks, vs)))
    else:
        cache = KVCache(ck.to(dev, dtype), cv.to(dev, dtype))
    x = torch.randn(rows, K, d, generator=gen).to(dev, dtype)
    rs = np.random.RandomState(rows)
    tl = rs.randint(0, ttm + 1, rows)
    tl[0] = 0
    cl = rs.randint(1, pm + 1, rows)
    lens = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (tl, cl)]
    return p, x, cache, lens, ttm, pm, h


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('index_kind', ['scalar', 'per_row'])
@pytest.mark.parametrize('chunk', [None, 64], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('widths', sorted(PERSISTENT_WIDTHS))
@pytest.mark.parametrize('variant', VERIFY_VARIANTS)
def test_persistent_step_equals_the_phased_route(dev, variant, widths, chunk, index_kind,
                                                 dtype):
    """y and the whole cache (codes and scales too) bit for bit; the per-row
    rows at the first generated slot, both sides of the chunk boundary, S - 2,
    S - 1 and frozen at S."""
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, dtype, widths)
    S = cache.k.shape[2]
    assert fd.cache_chunk(cache, h, chunk) == (chunk or S)
    rows = x.shape[0]
    if index_kind == 'per_row':
        index = torch.tensor([ttm + pm, 50, 63, 64, 100, S - 2, S - 1, S], dtype=torch.int32,
                             device=dev)
        slots = index
    else:
        index = ttm + pm + 37
        slots = torch.full((rows,), index, dtype=torch.int32, device=dev)
    c_a, c_b = (KVCache(*(t.clone() for t in cache if t is not None)) for _ in range(2))
    before = fd.COUNTERS[variant].count
    y_a, _ = fd.fused_decode_step(p, x, h, c_a, index, tl, cl, ttm, pm, chunk_override=chunk)
    assert fd.COUNTERS[variant].count == before + 1
    y_b, _ = fd.fused_verify_step_phased(p, x, h, c_b, slots, tl, cl, ttm, pm,
                                         chunk_override=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y_a.float()).all()
    assert torch.equal(y_a, y_b)
    for a, b in zip(c_a, c_b):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize('chunk', [None, 64], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('variant', ['dense', 'w8a8_kv8'])
def test_persistent_step_rows_do_not_depend_on_each_other(dev, variant, chunk):
    """Each row of an 8-row step (per-row index, bf16) equals that row stepped
    alone, y and cache bit for bit, and three repeats of the 8-row step from
    the same cache are identical: a joint decode's rows compute as their solo
    decodes do."""
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, torch.bfloat16,
                                                          'serving')
    S = cache.k.shape[2]
    index = torch.tensor([ttm + pm, 50, 63, 64, 100, S - 2, S - 1, S], dtype=torch.int32,
                         device=dev)
    runs = []
    for _ in range(3):
        c = KVCache(*(t.clone() for t in cache if t is not None))
        y, _ = fd.fused_decode_step(p, x, h, c, index, tl, cl, ttm, pm, chunk_override=chunk)
        runs.append((y, c))
    y, full = runs[0]
    for y2, c2 in runs[1:]:
        assert torch.equal(y2, y) and all(torch.equal(a, b) for a, b in zip(c2, full)
                                          if a is not None)
    for r in range(x.shape[0]):
        one = KVCache(*(t[:, r:r + 1].clone() for t in cache if t is not None))
        y1, _ = fd.fused_decode_step(p, x[r:r + 1].contiguous(), h, one,
                                     index[r:r + 1].contiguous(), tl[r:r + 1].contiguous(),
                                     cl[r:r + 1].contiguous(), ttm, pm, chunk_override=chunk)
        torch.cuda.synchronize()
        assert torch.equal(y1[0], y[r])
        assert all(torch.equal(a[:, r:r + 1], b) for a, b in zip(full, one) if a is not None)


@pytest.mark.parametrize('variant', ['dense', 'w8a8_kv8'])
def test_persistent_step_is_one_device_kernel(dev, variant):
    """torch.profiler: three #6 launches (chunked, per-row index) run three
    device kernels, each the persistent step; the phased route's kernels do
    not run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, torch.bfloat16,
                                                          'serving')
    index = torch.tensor([ttm + pm, 50, 63, 64, 100, 126, 127, 128], dtype=torch.int32,
                         device=dev)
    fd.fused_decode_step(p, x, h, cache, index, tl, cl, ttm, pm, chunk_override=64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10000)   # the profiler may miss its window's first kernel
        torch.cuda.synchronize()
        for _ in range(3):
            fd.fused_decode_step(p, x, h, cache, index, tl, cl, ttm, pm, chunk_override=64)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not any(w in e.name.lower() for w in ('sleep', 'spin'))]
    assert len(names) == 3 and all('step_persistent_kernel' in n for n in names), names


@pytest.mark.parametrize('variant', ['dense', 'w8a8_kv8'])
def test_persistent_verify_is_one_device_kernel(dev, variant):
    """torch.profiler: three #7 launches (chunked, K = 4, the int8 cache's
    write phase included) run three device kernels, each the persistent
    step; the phased kernels do not run.  A profile that saw fewer than three
    lost records (chip_smoke.py's step profile meets the same; late in a long
    process the profiler has kept one kernel of three, where a fresh
    process saw all three): it is taken again, up to three times, with 50 ms
    of host time at each end of its window, and one must see exactly three;
    a phased kernel, or more than three, fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    K = 4
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, torch.bfloat16,
                                                          'serving', rows=4, K=K)
    index = verify_twin_slots(ttm, pm, cache.k.shape[2], K, dev)
    fd.fused_verify_step(p, x, h, cache, index, tl, cl, ttm, pm, chunk_override=64)
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        before = fd.VERIFY_COUNTERS[variant].count
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(10000)   # the profiler may miss its window's first kernel
            torch.cuda.synchronize()
            time.sleep(0.05)
            for _ in range(3):
                fd.fused_verify_step(p, x, h, cache, index, tl, cl, ttm, pm, chunk_override=64)
            torch.cuda.synchronize()
            time.sleep(0.05)
        assert fd.VERIFY_COUNTERS[variant].count == before + 3
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not any(w in e.name.lower() for w in ('sleep', 'spin'))]
        assert len(names) <= 3 and all('step_persistent_kernel' in n for n in names), names
        seen.append(len(names))
        if len(names) == 3:
            break
    assert seen[-1] == 3, seen


@pytest.mark.parametrize('layout', ['w', 'q', 'q4'])
@pytest.mark.parametrize('dims', [(256, 4, 1024), (1024, 16, 4096), (3072, 24, 3072),
                                  (6144, 48, 6144)], ids=['serving', 'w204m', 'k3072',
                                                          'k6144'])
def test_persistent_grid_fills_the_card(dev, layout, dims):
    """The launcher's grid is every block the card holds at once (SM count x
    blocks per SM, at least one a SM) and its shared memory the plan's."""
    d, h, dff = dims
    if fd.fit_error(d, h, dff, layout) is not None:
        pytest.skip(f'the kernels do not take d={d}, dff={dff} in {layout!r}')
    blocks, smem = fd.step_grid(torch.bfloat16, torch.bfloat16, layout, d // h, d, dff)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert blocks >= sms and blocks % sms == 0
    assert smem == fd.persistent_plan(2, 8, d, dff, h, 128, 128, layout)['smem_bytes']


def test_persistent_step_refuses_what_it_does_not_take(dev):
    """A block of more than one token a row is the verify step's (#7), and
    the launcher's sizing refuses head dims and widths the kernel does not
    take with a CUDA error; a bfloat16 model over a float32 cache it sizes
    as the float32 pair (the shared memory does not depend on the cache)."""
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, 'dense', torch.float32,
                                                          'serving')
    block = torch.randn(x.shape[0], 4, x.shape[2], device=dev)
    with pytest.raises(ValueError, match='contiguous'):
        fd.fused_decode_step(p, block, h, cache, ttm + pm, tl, cl, ttm, pm)
    for hd, d, dff in ((48, 192, 768), (64, 256, 8192)):
        with pytest.raises(RuntimeError, match='CUDA error'):
            fd.step_grid(torch.float32, torch.float32, 'w', hd, d, dff)
    mixed = fd.step_grid(torch.bfloat16, torch.float32, 'w', 64, 256, 1024)
    assert mixed[0] > 0 and mixed[1] == fd.step_grid(torch.float32, torch.float32, 'w', 64,
                                                     256, 1024)[1]


# The persistent #7 against its phased twin: blocks of K tokens on 4 rows at
# their own start slots in a cache of S = 128 -- the first generated slot,
# slot 63 (the block straddles the chunk boundary at 64), S - K (the block
# ends at S - 1) and S - 1 (the block's slots past S - 1 are skipped).
def verify_twin_slots(ttm, pm, S, K, dev):
    return torch.tensor([ttm + pm, 63, S - K, S - 1], dtype=torch.int32, device=dev)


def hold_to_the_twin(p, x, h, cache, index, tl, cl, ttm, pm, chunk):
    """Run #7 and its phased twin on clones of ``cache``: y and the whole
    cache (codes and scales too) bit for bit; #7 counted once in its
    variant (and, below S, the chunked counter), the twin once in its own.
    Returns (y, the cache #7 left)."""
    var = fd.variant(p, cache)
    c_a, c_b = (KVCache(*(t.clone() for t in cache if t is not None)) for _ in range(2))
    counters = (fd.VERIFY_COUNTERS[var], fd.CHUNKED_COUNTERS['fused_verify_step'],
                fd.PHASED_COUNTER)
    before = [n.count for n in counters]
    y_a, _ = fd.fused_verify_step(p, x, h, c_a, index, tl, cl, ttm, pm, chunk_override=chunk)
    y_b, _ = fd.fused_verify_step_phased(p, x, h, c_b, index, tl, cl, ttm, pm,
                                         chunk_override=chunk)
    torch.cuda.synchronize()
    chunked = fd.cache_chunk(cache, h, chunk) < cache.k.shape[2]
    assert [n.count - b for n, b in zip(counters, before)] == [1, int(chunked), 1]
    assert torch.isfinite(y_a.float()).all()
    assert torch.equal(y_a, y_b), float((y_a.float() - y_b.float()).abs().max())
    for a, b in zip(c_a, c_b):
        if a is not None:
            assert torch.equal(a, b)
    return y_a, c_a


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('K', [2, 4, 8])
@pytest.mark.parametrize('chunk', [None, 64], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('widths', sorted(PERSISTENT_WIDTHS))
@pytest.mark.parametrize('variant', VERIFY_VARIANTS)
def test_persistent_verify_equals_the_phased_twin(dev, variant, widths, chunk, K, dtype):
    """#7 as one cooperative launch, bit for bit against the phased twin, in
    every weight x cache variant, whole-S and chunked, at the serving and
    204M widths; every block written where the twin writes it, a block's
    slots at S and past skipped (that row's cache past S - K + 1 unchanged
    but for the slots the block wrote)."""
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, dtype, widths, rows=4,
                                                          K=K)
    S = cache.k.shape[2]
    assert fd.cache_chunk(cache, h, chunk) == (chunk or S)
    index = verify_twin_slots(ttm, pm, S, K, dev)
    _, out = hold_to_the_twin(p, x, h, cache, index, tl, cl, ttm, pm, chunk)
    written = written_slots(index, K, S)
    for got, orig in zip(out, cache):
        if got is not None:
            assert torch.equal(got[:, ~written], orig[:, ~written])
            assert not torch.equal(got[:, 3, S - 1], orig[:, 3, S - 1])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('chunk', [None, 64], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('variant', ['kv8', 'w8a8_kv8', 'w4a16_kv8'])
def test_persistent_verify_int8_queries_read_their_blocks_slots(dev, variant, chunk, dtype):
    """The hazard of an int8 cache at K > 1: query i reads the slots of
    queries 0 .. i-1 of its block, which other blocks of the grid quantize.
    12 rows x K = 8 at the 204M widths (96 query rows, every block busy) with
    the block's slots first holding the largest codes and scales the cache
    takes, then zeros: y and the cache are the same bits both times (no
    query read a slot before its write landed) and the phased twin's, in
    five repeats."""
    K = 8
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, dtype, 'w204m', rows=12,
                                                          K=K)
    S = cache.k.shape[2]
    index = torch.tensor([ttm + pm + (7 * r) % 60 for r in range(11)] + [S - K],
                         dtype=torch.int32, device=dev)
    written = written_slots(index, K, S)
    results = []
    for fill in (127, 0):
        stale = KVCache(*(t.clone() for t in cache))
        for t in stale:
            t[:, written] = fill if t.dtype == torch.int8 else float(fill + 1)
        for _ in range(5):
            results.append(hold_to_the_twin(p, x, h, stale, index, tl, cl, ttm, pm, chunk))
    y0, c0 = results[0]
    for y, c in results[1:]:
        assert torch.equal(y, y0) and all(torch.equal(a, b) for a, b in zip(c, c0))


@pytest.mark.parametrize('chunk', [None, 64], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('variant', ['dense', 'w8a8_kv8'])
def test_persistent_verify_rows_do_not_depend_on_each_other(dev, variant, chunk):
    """Each row of a 4-row verify pass (K = 4, bf16) equals that row's block
    verified alone, y and cache bit for bit, and three repeats of the 4-row
    pass from the same cache are identical."""
    K = 4
    p, x, cache, (tl, cl), ttm, pm, h = persistent_inputs(dev, variant, torch.bfloat16,
                                                          'serving', rows=4, K=K)
    index = verify_twin_slots(ttm, pm, cache.k.shape[2], K, dev)
    runs = []
    for _ in range(3):
        c = KVCache(*(t.clone() for t in cache if t is not None))
        y, _ = fd.fused_verify_step(p, x, h, c, index, tl, cl, ttm, pm, chunk_override=chunk)
        runs.append((y, c))
    y, full = runs[0]
    for y2, c2 in runs[1:]:
        assert torch.equal(y2, y) and all(torch.equal(a, b) for a, b in zip(c2, full)
                                          if a is not None)
    for r in range(x.shape[0]):
        one = KVCache(*(t[:, r:r + 1].clone() for t in cache if t is not None))
        y1, _ = fd.fused_verify_step(p, x[r:r + 1].contiguous(), h, one,
                                     index[r:r + 1].contiguous(), tl[r:r + 1].contiguous(),
                                     cl[r:r + 1].contiguous(), ttm, pm, chunk_override=chunk)
        torch.cuda.synchronize()
        assert torch.equal(y1[0], y[r])
        assert all(torch.equal(a[:, r:r + 1], b) for a, b in zip(full, one) if a is not None)


def test_verify_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """The persistent #7 and its phased twin refuse the same inputs, before
    any launch (no count moves)."""
    p, x, cache, (tl, cl), ttm, pm, index = verify_inputs(dev, 'dense', torch.float32, 32, 3, 4)
    c = KVCache(*cache)
    counters = (fd.PHASED_COUNTER, *fd.VERIFY_COUNTERS.values())
    before = [n.count for n in counters]
    for step in (fd.fused_verify_step, fd.fused_verify_step_phased):
        with pytest.raises(ValueError, match='start slots'):
            step(p, x, 2, c, index.long(), tl, cl, ttm, pm)
        with pytest.raises(ValueError, match='start slots'):
            step(p, x, 2, c, index[:2].contiguous(), tl, cl, ttm, pm)
        with pytest.raises(ValueError, match='start slots'):
            step(p, x, 2, c, index.cpu(), tl, cl, ttm, pm)
        with pytest.raises(ValueError, match='start slots'):
            step(p, x, 2, c, ttm + pm, tl, cl, ttm, pm)
        with pytest.raises(ValueError, match='block'):
            step(p, x[:, 0], 2, c, index, tl, cl, ttm, pm)
        with pytest.raises(ValueError, match='contiguous'):
            step(p, x.transpose(0, 1).contiguous().transpose(0, 1), 2, c, index, tl, cl, ttm,
                 pm)
    assert [n.count for n in counters] == before
    odd = torch.randn(1, 2, 4, 96, device=dev)           # hd 48: no kernel takes it
    pw = transformer_init(torch.Generator().manual_seed(0), 1, 96, 2, 192, adaptive_norm=False)
    pw = map_tree(lambda a: a.to(dev).contiguous(), pw)
    ow = KVCache(*(torch.zeros(1, 1, 48, 96, device=dev) for _ in range(2)))
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for call in (lambda: fd.fused_verify_step(pw, odd[:, :1].reshape(1, 4, 96)
                                              .contiguous(), 2, ow, 40, one, one, 8, 8),
                 lambda: fd.fused_verify_step_phased(pw, odd[:, :1].reshape(1, 4, 96)
                                                     .contiguous(), 2, ow, one, one, one, 8, 8),
                 lambda: fd.fused_decode_step(pw, odd[0, :1, :1].contiguous(), 2, ow, 40, one,
                                              one, 8, 8)):
        with pytest.raises(ValueError, match='head dims'):
            call()
    assert 'widths up to 5120' in fd.fit_error(512, 4, 6144, 'q')


def test_head_dim_16_routes_to_the_plain_path(dev):
    """hd 16 under 'auto' decodes (speculative and plain) and trains on the
    card through the plain versions, with no kernel launch; forcing either
    kernel raises, naming the head dims."""
    import dataclasses

    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.models import ValleAR
    cfg = ConfigValle(d_model=64, n_heads=4, dim_feedforward=128, num_layers=2, dropout=0.0,
                      max_audio_len=6, num_beams=1, temperature=0.0, ignore_eos=True,
                      kv_cache_dtype='float32', matmul_precision='highest')
    assert not cfg.flash_enabled(dev) and not cfg.fused_decode_enabled(dev)
    rs = np.random.RandomState(0)
    toks, codes = [rs.randint(0, 256, (5,))], [rs.randint(0, 1024, (4, 8))]
    counters = [fa.COUNTER, fa.BWD_FUSED_COUNTER, *fd.COUNTERS.values(),
                *fd.VERIFY_COUNTERS.values()]
    before = [c.count for c in counters]
    model = ValleAR(cfg, device=dev)
    plain = model.generate_batch(toks, codes)
    spec = ValleAR(dataclasses.replace(cfg, speculative_k=3), params=model.params,
                   device=dev).generate_batch(toks, codes)
    assert torch.equal(plain[0], spec[0]) and len(plain[0]) == 6
    batch = {'tokens': rs.randint(0, 256, (2, 8)), 'tokens_lens': [8, 6],
             'codes': rs.randint(0, 1026, (2, 12)), 'codes_lens': [12, 9],
             'target': rs.randint(0, 1025, (2, 12))}
    with torch.inference_mode(False), torch.enable_grad():
        batch = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        params = map_tree(lambda a: a.clone().requires_grad_(), model.params)
        loss, _ = ar_mod.loss_fn(params, cfg, batch)
        loss.backward()
    assert torch.isfinite(loss) and [c.count for c in counters] == before
    for forced in (dict(use_fused_decode=True), dict(use_flash_attention=True)):
        with pytest.raises(ValueError, match='head dims'):
            ValleAR(dataclasses.replace(cfg, **forced), params=model.params,
                    device=dev).generate_batch(toks, codes)


RVQ_CASES = {   # (B, T, n_q): the chip_smoke shapes, then tails of 1 and 31 frames
    'prompt_1x150': (1, 150, 8), 'batch_16x300': (16, 300, 8), 'ragged_3x77': (3, 77, 4),
    'tail_1x33': (1, 33, 8), 'tail_2x31': (2, 31, 2)}


def assert_codes_within_ties(codebooks, latents, got, want):
    """Kernel codes equal the plain ones except at ties within f32 rounding
    (``krvq.TIE_RTOL``), judged by replaying the plain stages on the kernel's
    codes."""
    gaps, tops = krvq.code_gaps(codebooks, latents, got)
    assert bool((gaps <= krvq.TIE_RTOL * tops.clamp(min=1.0)).all()), float(gaps.max())
    assert float((got != want).float().mean()) < 0.01


@pytest.mark.parametrize('case', sorted(RVQ_CASES))
def test_rvq_kernel_matches_plain(dev, case):
    b, t, n_q = RVQ_CASES[case]
    gen = torch.Generator().manual_seed(b * 1000 + t)
    cb = (torch.rand(8, 1024, 128, generator=gen) * 2 - 1).to(dev)
    lat = torch.randn(b, t, 128, generator=gen).to(dev)
    before = krvq.COUNTER.count
    got = krvq.rvq_encode_fused(cb, lat, n_q)
    assert krvq.COUNTER.count == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (b, n_q, t)
    assert_codes_within_ties(cb, lat, got, krvq.rvq_encode_plain(cb, lat, n_q))


def test_rvq_wrapper_refuses_what_the_kernel_does_not_take(dev):
    cb = torch.rand(8, 1024, 128, device=dev)
    lat = torch.randn(1, 10, 128, device=dev)
    with pytest.raises(TypeError, match='float32'):
        krvq.rvq_encode_fused(cb, lat.bfloat16())
    with pytest.raises(ValueError, match='128'):
        krvq.rvq_encode_fused(cb[..., :64].contiguous(), lat[..., :64].contiguous())
    with pytest.raises(ValueError, match='contiguous'):
        krvq.rvq_encode_fused(cb, torch.randn(1, 128, 10, device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match='multiple'):
        krvq.rvq_encode_fused(cb[:, :1000].contiguous(), lat)
    with pytest.raises(ValueError, match='n_q'):
        krvq.rvq_encode_fused(cb, lat, 9)


def test_rvq_wrapper_refuses_a_plan_the_kernel_does_not_build(dev):
    cb = torch.rand(8, 1024, 128, device=dev)
    lat = torch.randn(1, 10, 128, device=dev)
    wide = krvq.TILES.index((32, 128, 8, 4, 1))
    for plan in (dict(tile=len(krvq.TILES), cluster=1), dict(tile=wide, cluster=3),
                 dict(tile=wide, cluster=16)):        # 1024 / 16 < the tile's 128 codewords
        with pytest.raises(ValueError, match='no tile'):
            krvq.rvq_encode_fused(cb, lat, plan=plan)


def test_rvq_tiles_are_the_kernels_table(dev):
    """kernels.rvq.TILES and tile_smem mirror csrc/rvq.cu's TILE_DIMS and
    Tile::SMEM, in its order (the plan passes an index into it)."""
    import ctypes
    from valle2_tpu_torch.kernels import _build
    fn = _build.load('rvq').valle2_rvq_tile
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_long
    for tile, dims in enumerate(krvq.TILES):
        assert tuple(fn(tile, w) for w in range(5)) == dims
        assert fn(tile, 5) == krvq.tile_smem(tile)
    assert fn(len(krvq.TILES), 0) == 0


def rvq_plans(v: int):
    """Every (tile, cluster) the kernel builds that divides V."""
    return [dict(tile=i, cluster=k) for i, (_, c, *_) in enumerate(krvq.TILES)
            for k in krvq.CLUSTERS if v % (k * c) == 0]


@pytest.mark.parametrize('case', ['prompt_1x150', 'ragged_3x77', 'tail_1x33'])
def test_rvq_kernel_every_plan_matches_plain(dev, case):
    """Every tile and cluster size (16: a non-portable cluster) under the
    tie rule, each one launch."""
    b, t, n_q = RVQ_CASES[case]
    gen = torch.Generator().manual_seed(b + t)
    cb = (torch.rand(8, 1024, 128, generator=gen) * 2 - 1).to(dev)
    lat = torch.randn(b, t, 128, generator=gen).to(dev)
    want = krvq.rvq_encode_plain(cb, lat, n_q)
    for plan in rvq_plans(1024):
        before = krvq.COUNTER.count
        got = krvq.rvq_encode_fused(cb, lat, n_q, plan=plan)
        assert krvq.COUNTER.count == before + 1
        torch.cuda.synchronize()
        assert got.shape == (b, n_q, t), plan
        assert_codes_within_ties(cb, lat, got, want)


@pytest.mark.parametrize('v', [128, 2048])
def test_rvq_kernel_every_plan_at_other_codebook_sizes(dev, v):
    """V = 128: one slice, a cluster of 1; V = 2048: clusters up to 16 (the
    non-portable size) of 128-codeword slices.  The plan's choice and each
    plan under the tie rule."""
    gen = torch.Generator().manual_seed(v)
    cb = (torch.rand(8, v, 128, generator=gen) * 2 - 1).to(dev)
    lat = torch.randn(2, 150, 128, generator=gen).to(dev)
    want = krvq.rvq_encode_plain(cb, lat)
    plans = rvq_plans(v)
    assert any(p['cluster'] == (16 if v == 2048 else 1) for p in plans)
    for plan in (None, *plans):
        got = krvq.rvq_encode_fused(cb, lat, plan=plan)
        torch.cuda.synchronize()
        assert_codes_within_ties(cb, lat, got, want)


def test_rvq_kernel_resolves_exact_ties_across_ctas_to_the_lower_index(dev):
    """A codeword of every stage duplicated into another slice and frames
    near the duplicated sum: each stage's two copies score bit-equal on
    whichever CTAs hold them, and every plan must give the plain codes
    exactly -- the lower index."""
    a = torch.tensor([5 + 3 * q for q in range(8)])
    b = torch.tensor([600 + 41 * q for q in range(8)])
    gen = torch.Generator().manual_seed(3)
    cb = (torch.rand(8, 1024, 128, generator=gen) * 2 - 1) * 0.5 ** torch.arange(8.0)[:, None, None]
    cb[torch.arange(8), b] = cb[torch.arange(8), a]
    lat = cb[torch.arange(8), a].sum(0) + 1e-4 * torch.randn(1, 150, 128, generator=gen)
    cb, lat = cb.to(dev), lat.to(dev)
    want = krvq.rvq_encode_plain(cb, lat)
    assert bool((want.cpu() == a.int()[None, :, None]).all())
    for plan in (None, *rvq_plans(1024)):
        got = krvq.rvq_encode_fused(cb, lat, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


RVQ_PROFILE = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from valle2_tpu_torch.kernels import rvq as krvq
cb = torch.rand(8, 1024, 128, device='cuda')
lat = torch.randn(1, 150, 128, device='cuda')
krvq.rvq_encode_fused(cb, lat)
torch.cuda.synchronize()
seen = []
for _ in range(3):
    before = krvq.COUNTER.count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(3):
            krvq.rvq_encode_fused(cb, lat)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not any(w in e.name.lower() for w in ('sleep', 'spin'))]
    seen.append(dict(launches=krvq.COUNTER.count - before, names=names))
    if len(names) == 3:
        break
print('PROFILE ' + json.dumps(seen), flush=True)
"""


def test_rvq_kernel_is_one_device_kernel_a_call(dev):
    """torch.profiler: three encodes at the prompt's shape run three device
    kernels, each the cluster kernel (|c|^2 folded in, nothing cached).
    Profiled in a process of its own (late in a long pytest process
    torch.profiler has kept one device kernel of several); a profile that
    saw fewer is taken again, up to three times, and one must see three."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, '-c', RVQ_PROFILE, str(here.parent)],
                         capture_output=True, text=True, timeout=300, cwd=here.parent)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith('PROFILE ')), None)
    assert line is not None, out.stderr[-3000:]
    seen = json.loads(line.removeprefix('PROFILE '))
    for attempt in seen:
        assert attempt['launches'] == 3
        names = attempt['names']
        assert len(names) <= 3 and all('rvq_cluster_kernel' in n for n in names), names
    assert len(seen[-1]['names']) == 3, seen


@pytest.fixture
def codecs(dev):
    from valle2_tpu_torch.codec import Encodec
    cpu = Encodec(seed=3, device='cpu')
    return cpu, Encodec(params=cpu.params, device=dev)


def test_encodec_encode_on_card_equals_cpu_route(dev, codecs):
    cpu, card = codecs
    rs = np.random.RandomState(0)
    wavs = (rs.randn(2, 24000) * 0.3).astype(np.float32)
    before = krvq.COUNTER.count
    got = card.batch_encode(wavs)
    assert krvq.COUNTER.count == before + 1
    want = cpu.batch_encode(wavs)
    latents = card.batch_get_embedding(wavs).transpose(1, 2).contiguous()
    assert_codes_within_ties(card.params['rvq']['codebooks'], latents, got, want.to(dev))
    assert torch.equal(got.cpu(), want)


def test_encode_ignores_the_callers_tf32_scope(dev, codecs):
    from valle2_tpu_torch.config import tf32_scope
    _, card = codecs
    wav = (np.random.RandomState(1).randn(36000) * 0.3).astype(np.float32)
    with tf32_scope(False):
        exact = card.encode(wav)
        emb = card.get_embedding(wav)
    with tf32_scope(True):
        assert torch.equal(card.encode(wav), exact)
        assert torch.equal(card.get_embedding(wav), emb)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


FOLD_CASES = {
    # (b, h, s, tokens_total, meta [tokens_valid, kv_end], causal): #2 walks
    # the h heads of a (q-tile, batch row) block
    'one_head_causal': (2, 1, 100, 30, [[30, 100], [12, 77]], True),
    'four_heads_bidirectional': (2, 4, 130, 40, [[40, 130], [25, 90]], False),
    'three_heads_no_tokens': (2, 3, 70, 20, [[0, 70], [20, 64]], True),
    'sixteen_heads_causal': (2, 16, 200, 64, [[64, 200], [40, 150]], True),
    'sixteen_heads_no_tokens_bidirectional': (1, 16, 129, 32, [[0, 129]], False),
    # s under one 64-row tile: the TMA boxes reach past every edge of q, k, v, o
    'shorter_than_a_tile': (2, 2, 40, 16, [[16, 40], [0, 33]], True),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(FOLD_CASES))
def test_folded_flash_kernel_matches_plain_and_per_head(dev, monkeypatch, case, hd, dtype):
    """#2 (bf16: wgmma + TMA; f32: the CUDA cores, both on the persistent
    item schedule) against the plain version, bit for bit against #1 on the
    same inputs (the same 64-key tiles, element ownership and per-row
    order) and against itself on a second call; ``fold_heads=None`` under
    VALLE2_FLASH_FOLD=1 launches #2 and not #1."""
    b, h, s, tt, meta, causal = FOLD_CASES[case]
    gen = torch.Generator().manual_seed(hd + h)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, dtype) for _ in range(3))
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    before = (fa.COUNTER.count, fa.FOLD_COUNTER.count)
    o, lse = fa.flash_attention_folded(q, k, v, meta, tt, causal)
    assert (fa.COUNTER.count, fa.FOLD_COUNTER.count) == (before[0], before[1] + 1)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    o1, lse1 = fa.flash_attention(q, k, v, meta, tt, causal, fold_heads=False)
    torch.cuda.synchronize()
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    o_again, lse_again = fa.flash_attention_folded(q, k, v, meta, tt, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o_again) and torch.equal(lse, lse_again)
    monkeypatch.setenv('VALLE2_FLASH_FOLD', '1')
    before = (fa.COUNTER.count, fa.FOLD_COUNTER.count)
    o2, _ = fa.flash_attention(q, k, v, meta, tt, causal)
    assert (fa.COUNTER.count, fa.FOLD_COUNTER.count) == (before[0], before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(o2, o)


FOLD_SCHEDULE_CASES = {
    # (b, h, s, tokens_total, causal): the serving prefill leaves SMs idle
    # (42 bf16 items), the 204M training shape has more items than SMs
    'fewer_items_than_sms': (3, 4, 385, 128, True),
    'more_items_than_sms': (16, 16, 640, 128, True),
    'more_items_than_sms_bidirectional': (32, 8, 640, 128, False),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FOLD_SCHEDULE_CASES))
def test_folded_kernel_persistent_grid_fewer_and_more_items_than_slots(dev, case, dtype):
    """#2's persistent grid with fewer items than SMs x blocks an SM (every
    item a block of its own) and with more (blocks walk several items,
    their heads' rings never drained between them): == the plain version,
    == #1 bit for bit, and == itself on a second call."""
    b, h, s, tt, causal = FOLD_SCHEDULE_CASES[case]
    gen = torch.Generator().manual_seed(b * h)
    q, k, v = (torch.randn(b, h, s, 64, generator=gen).to(dev, dtype) for _ in range(3))
    meta = torch.tensor([[max(tt - 7 * i, 0) if i < b - 1 else 0, s - 13 * i]
                         for i in range(b)], dtype=torch.int32, device=dev)
    plan = fa.fold_plan_for(q, tt, causal)
    slots = fa.fold_slots(dev, dtype, 64)
    assert (plan.items < slots) == case.startswith('fewer')
    assert plan.grid == min(plan.items, slots)
    o, lse = fa.flash_attention_folded(q, k, v, meta, tt, causal)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    o1, lse1 = fa.flash_attention(q, k, v, meta, tt, causal, fold_heads=False)
    o2, lse2 = fa.flash_attention_folded(q, k, v, meta, tt, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_folded_sass_runs_wgmma_and_tma_in_bf16(dev):
    """The built flash_attention library's #2 in bf16 (flash_fold_tc_kernel,
    one per head dim) issues HGMMA (wgmma), UTMALDG and UTMASTG (TMA loads
    and stores), and no HMMA (the warp-level mma.sync of #1)."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from valle2_tpu_torch.kernels import _build
    _build.load('flash_attention')
    tool = shutil.which('cuobjdump') or str(Path(_build._nvcc()).with_name('cuobjdump'))
    sass = subprocess.run([tool, '-sass', str(_build._lib_path('flash_attention'))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    bodies = {}
    for part in re.split(r'\n\s*Function : ', sass)[1:]:
        name, _, body = part.partition('\n')
        bodies[name.strip()] = body
    found = [b for name, b in bodies.items() if 'flash_fold_tc_kernel' in name]
    assert len(found) == 3, list(bodies)
    for body in found:
        for op in ('HGMMA', 'UTMALDG', 'UTMASTG'):
            assert re.search(rf'\b{op}\b', body), op
        assert not re.search(r'\bHMMA\b', body)


def test_folded_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """#2's wrapper raises, and launches nothing, on a head dim no kernel
    takes and on inputs that are not 16-byte aligned: bf16 (the TMA maps
    need it) and f32 (cp.async stages 16 bytes a thread); the same f32
    values at an aligned address run."""
    meta = torch.tensor([[4, 16]], dtype=torch.int32, device=dev)
    before = fa.FOLD_COUNTER.count
    w = torch.randn(1, 2, 16, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='head dims'):
        fa.flash_attention_folded(w, w, w, meta, 4)
    q = torch.randn(1 * 2 * 16 * 32 + 1, device=dev)
    shifted = q[1:].view(1, 2, 16, 32)
    with pytest.raises(ValueError, match='16-byte aligned'):
        b16 = q.bfloat16()[1:].view(1, 2, 16, 32)
        fa.flash_attention_folded(b16, b16, b16, meta, 4)
    with pytest.raises(ValueError, match='16-byte aligned'):
        fa.flash_attention_folded(shifted, shifted, shifted, meta, 4)
    assert fa.FOLD_COUNTER.count == before
    copy = shifted.clone()
    o, _ = fa.flash_attention_folded(copy, copy, copy, meta, 4)
    o_ref, _ = fa.flash_attention_plain(copy, copy, copy, meta, 4)
    assert_close(o, o_ref, torch.float32)


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_fold_grads_equal_the_per_head_route(dev, monkeypatch, model):
    """A 2-layer model at the serving widths (f32, TF32 off): loss and every
    grad with VALLE2_FLASH_FOLD=1 == with it 0, each arm launching only its
    forward (#2 or #1) and the fused backward #3."""
    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.models import nar as nar_mod
    from valle2_tpu_torch.train import init_state, tree_leaves
    cfg = ConfigValle(dropout=0.0, matmul_precision='highest', use_flash_attention=True,
                      num_layers=2)
    rs = np.random.RandomState(7)
    batch = {'tokens': rs.randint(0, 256, (2, 24)), 'tokens_lens': np.asarray([24, 17]),
             'codes_lens': np.asarray([96, 71])}
    if model == 'ValleAR':
        batch.update(codes=rs.randint(0, 1026, (2, 96)), target=rs.randint(0, 1025, (2, 96)))
    else:
        batch.update(codes=rs.randint(0, 1024, (2, 96, 8)))
    with torch.inference_mode(False):
        batch = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in batch.items()}
        params = init_state(cfg, model, device=dev).params
        leaves = tree_leaves(params)
        got = {}
        for arm in ('1', '0'):
            monkeypatch.setenv('VALLE2_FLASH_FOLD', arm)
            before = [c.count for c in (fa.COUNTER, fa.FOLD_COUNTER, fa.BWD_FUSED_COUNTER)]
            with precision_scope(cfg):
                loss, _ = (ar_mod.loss_fn(params, cfg, batch) if model == 'ValleAR'
                           else nar_mod.loss_at_stage(params, cfg, batch, 3))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            launched = [c.count - n for c, n in zip(
                (fa.COUNTER, fa.FOLD_COUNTER, fa.BWD_FUSED_COUNTER), before)]
            n = cfg.num_layers
            assert launched == ([0, n, n] if arm == '1' else [n, 0, n])
            got[arm] = (loss.detach(), [torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, grads)])
    (lf, gf), (lo, go) = got['1'], got['0']
    torch.testing.assert_close(lf, lo, rtol=1e-5, atol=0)
    for a, w in zip(gf, go):   # per leaf; #3 sums dq through atomics in a varying order
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


GEMM_CALLS = {
    # name: (wrapper, keywords)
    'fullk_128x128': ('matmul_fullk', dict(bm=128, bn=128)),
    'fullk_128x256': ('matmul_fullk', dict(bm=128, bn=256)),
    'ksplit_128x128_k2': ('matmul_ksplit', dict(splits=2, bm=128, bn=128)),
    'ksplit_128x128_k3': ('matmul_ksplit', dict(splits=3, bm=128, bn=128)),
    'ksplit_128x256_k4': ('matmul_ksplit', dict(splits=4, bm=128, bn=256)),
}


@pytest.mark.parametrize('shape', [(256, 384, 512), (128, 1536, 256), (1280, 768, 1024)],
                         ids=str)
@pytest.mark.parametrize('call', sorted(GEMM_CALLS))
def test_gemm_kernels_match_plain(dev, call, shape):
    """#9 and #10 against matmul_plain within one bf16 ulp of the result plus
    the f32 summation-order error (gemm_roofline.tolerance); #10 is
    deterministic (a fixed slice order, no atomics)."""
    from valle2_tpu_torch.kernels import gemm
    from valle2_tpu_torch.probes.gemm_roofline import tolerance
    m, k, n = shape
    name, kw = GEMM_CALLS[call]
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
    b = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
    counter = gemm.FULLK_COUNTER if name == 'matmul_fullk' else gemm.KSPLIT_COUNTER
    before = counter.count
    got = getattr(gemm, name)(a, b, **kw)
    assert counter.count == before + 1
    want = gemm.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert bool(((got.float() - want.float()).abs() <= tolerance(a, b, want)).all())
    again = getattr(gemm, name)(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_gemm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from valle2_tpu_torch.kernels import gemm
    a = torch.ones(128, 64, dtype=torch.bfloat16, device=dev)
    b = torch.ones(64, 128, dtype=torch.bfloat16, device=dev)
    shifted = torch.ones(128 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(128, 64)
    with pytest.raises(ValueError, match='aligned'):
        gemm.matmul_fullk(shifted, b)
    with pytest.raises(ValueError, match='one CPU or CUDA device'):
        gemm.matmul_ksplit(a, b.cpu())
    with pytest.raises(ValueError, match='K % 96'):
        gemm.matmul_ksplit(a, b, splits=3)
    with pytest.raises(TypeError):
        gemm.matmul_fullk(a.float(), b.float())


def _gemm_operands(m, k, n, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=gen).to(dev, torch.bfloat16),
            torch.randn(k, n, generator=gen).to(dev, torch.bfloat16))


@pytest.mark.parametrize('shape', [(256, 384, 512), (128, 96, 256)], ids=str)
@pytest.mark.parametrize('bn', [128, 256])
def test_gemm_ksplit_one_slice_equals_fullk_bit_for_bit(dev, bn, shape):
    """#10 at splits=1 runs #9's mainloop over all of K and rounds the f32 sum
    once: the same bits as #9 at the same tile (K = 96 ends on a half stage)."""
    from valle2_tpu_torch.kernels import gemm
    a, b = _gemm_operands(*shape, dev, seed=bn + shape[1])
    full = gemm.matmul_fullk(a, b, bm=128, bn=bn)
    split = gemm.matmul_ksplit(a, b, splits=1, bm=128, bn=bn)
    torch.cuda.synchronize()
    assert torch.equal(full, split)


@pytest.mark.parametrize('splits', [5, 6, 7, 8])
@pytest.mark.parametrize('bn', [128, 256])
def test_gemm_ksplit_wide_clusters_match_plain_and_repeat(dev, bn, splits):
    """#10 with 5-8 K slices (a cluster of that many blocks, rows of the tile
    shared unevenly among them at 5, 6 and 7) within gemm_roofline.tolerance
    of matmul_plain, and the same bits from call to call."""
    from valle2_tpu_torch.kernels import gemm
    from valle2_tpu_torch.probes.gemm_roofline import tolerance
    m, k, n = 256, 32 * splits * 3, 2 * bn
    a, b = _gemm_operands(m, k, n, dev, seed=splits)
    got = gemm.matmul_ksplit(a, b, splits=splits, bm=128, bn=bn)
    want = gemm.matmul_plain(a, b)
    again = gemm.matmul_ksplit(a, b, splits=splits, bm=128, bn=bn)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert bool(((got.float() - want.float()).abs() <= tolerance(a, b, want)).all())
    assert torch.equal(got, again)


@pytest.mark.parametrize('shape', [(4096, 1024, 4096), (128, 64, 256)], ids=str)
@pytest.mark.parametrize('bn', [128, 256])
def test_gemm_fullk_persistent_grid_more_and_fewer_tiles_than_sms(dev, bn, shape):
    """#9's persistent grid: at 4096 x 4096 each block walks several tiles
    (the raster wraps); at 128 x 256 there are fewer tiles than SMs and the
    grid is that small."""
    from valle2_tpu_torch.kernels import gemm
    from valle2_tpu_torch.probes.gemm_roofline import tolerance
    m, k, n = shape
    a, b = _gemm_operands(m, k, n, dev, seed=m + bn)
    tiles = (m // 128) * (n // bn)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (tiles > sms) == (m == 4096)
    got = gemm.matmul_fullk(a, b, bm=128, bn=bn)
    want = gemm.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= tolerance(a, b, want)).all())


@pytest.mark.parametrize('splits', [2, 8])
def test_gemm_ksplit_allocates_only_its_output(dev, splits):
    """#10 sums its K slices in the cluster's shared memory: a call adds no
    more to the peak of allocated device memory than C's bytes."""
    from valle2_tpu_torch.kernels import gemm
    m, k, n = 2048, 32 * 8 * 4, 1024
    a, b = _gemm_operands(m, k, n, dev, seed=splits)
    gemm.matmul_ksplit(a, b, splits=splits)          # built and loaded before measuring
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    c = gemm.matmul_ksplit(a, b, splits=splits)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - before <= c.numel() * c.element_size()


def test_gemm_sass_runs_wgmma_and_tma_not_mma_sync(dev):
    """The built gemm library's #9 and #10 kernels issue HGMMA (wgmma) and
    UTMALDG (TMA loads), and no HMMA (the warp-level mma.sync of before)."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from valle2_tpu_torch.kernels import _build
    _build.load('gemm')
    tool = shutil.which('cuobjdump') or str(Path(_build._nvcc()).with_name('cuobjdump'))
    sass = subprocess.run([tool, '-sass', str(_build._lib_path('gemm'))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    bodies = {}
    for part in re.split(r'\n\s*Function : ', sass)[1:]:
        name, _, body = part.partition('\n')
        bodies[name.strip()] = body
    for kernel in ('gemm_fullk_kernel', 'gemm_ksplit_kernel'):
        found = [b for name, b in bodies.items() if kernel in name]
        assert len(found) == 2, (kernel, list(bodies))      # one per tile width
        for body in found:
            assert re.search(r'\bHGMMA\b', body) and re.search(r'\bUTMALDG\b', body)
            assert not re.search(r'\bHMMA\b', body)


# --- Tensor parallelism: 5c and the TP steps, virtual ranks on one card ---

TP_FORMATS = {   # (weights, cache): the formats the TP steps take
    'dense': ('compute', None), 'kv8': ('compute', 'int8'), 'w4a16': ('int4', None),
    'w4a16_kv8': ('int4', 'int8')}


@pytest.mark.parametrize('mp', [1, 2, 3, 4, 8])
def test_tp_allreduce_kernel_is_the_rank_ordered_sum(dev, mp):
    gen = torch.Generator().manual_seed(mp)
    parts = [torch.randn(5, 96, generator=gen).to(dev) for _ in range(mp)]
    before = ta.COUNTER.count
    got = ta.tp_allreduce(parts)
    want = ta.tp_allreduce_plain(parts)
    torch.cuda.synchronize()
    assert ta.COUNTER.count == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


RR_SHAPES = {'prefill': (3, 385, 256), 'odd': (5, 97)}   # odd: the scalar path (d % 4)


@pytest.mark.parametrize('epi', ['sum', 'bias', 'residual', 'bias_residual'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', sorted(RR_SHAPES))
@pytest.mark.parametrize('mp', [1, 2, 3, 4, 8])
def test_tp_row_reduce_kernel_equals_plain_bit_for_bit(dev, mp, shape, dtype, epi):
    """5c with the row-parallel epilogue, virtual ranks on one card: every
    rank's output bit-equal to ``tp_row_reduce_plain``; one launch, and no
    ordering call (the ranks share a card and a stream)."""
    gen = torch.Generator().manual_seed(mp * 7 + len(shape))
    shp = RR_SHAPES[shape]
    parts = [(torch.randn(*shp, generator=gen) * 10 ** (r % 3 - 1)).to(dev) for r in range(mp)]
    bias = torch.randn(shp[-1], generator=gen).to(dev, dtype) if 'bias' in epi else None
    biases = None if bias is None else [bias.clone() for _ in range(mp)]
    x = torch.randn(*shp, generator=gen).to(dev, dtype)
    res = [x.clone() for _ in range(mp)] if 'residual' in epi else None
    out_dtype = torch.float32 if epi == 'sum' else dtype
    before, calls = ta.COUNTER.count, ta.ordering_calls()
    got = ta.tp_row_reduce(parts, biases, res, out_dtype)
    want = ta.tp_row_reduce_plain(parts, biases, res, out_dtype)
    torch.cuda.synchronize()
    assert ta.COUNTER.count == before + 1 and ta.ordering_calls() == calls
    for g, w in zip(got, want):
        assert g.dtype == out_dtype and g.device == parts[0].device
        assert torch.equal(g, w)


RR_PROFILE = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from valle2_tpu_torch.kernels import tp_allreduce as ta
dev = torch.device('cuda')
parts = [torch.randn(3, 385, 256, device=dev) for _ in range(2)]
bias = torch.randn(256, device=dev)
res = [torch.randn(3, 385, 256, device=dev) for _ in range(2)]
run = lambda: ta.tp_row_reduce(parts, [bias, bias], res, torch.float32)
run()
torch.cuda.synchronize()
seen = []
for _ in range(3):
    before, calls = ta.COUNTER.count, ta.ordering_calls()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not any(w in e.name.lower() for w in ('sleep', 'spin'))]
    seen.append(dict(launches=ta.COUNTER.count - before,
                     ordering_calls=ta.ordering_calls() - calls, names=names))
    if len(names) == 3:
        break
print('PROFILE ' + json.dumps(seen), flush=True)
"""


def test_tp_row_reduce_is_one_device_kernel_a_sum(dev):
    """torch.profiler: three sums of two virtual ranks at the prefill's
    shape run three device kernels, each ``tp_row_reduce_kernel``, and no
    event or device call.  Profiled in a process of its own (late in a long
    pytest process torch.profiler has kept fewer device kernels than ran); a
    profile that saw fewer is taken again, up to three times."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, '-c', RR_PROFILE, str(here.parent)],
                         capture_output=True, text=True, timeout=300, cwd=here.parent)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith('PROFILE ')), None)
    assert line is not None, out.stderr[-3000:]
    seen = json.loads(line.removeprefix('PROFILE '))
    for attempt in seen:
        assert attempt['launches'] == 3 and attempt['ordering_calls'] == 0
        names = attempt['names']
        assert len(names) <= 3 and all('tp_row_reduce_kernel' in n for n in names), names
    assert len(seen[-1]['names']) == 3, seen


def test_tp_row_reduce_refuses_what_it_does_not_take(dev):
    parts = [torch.randn(4, 8, device=dev) for _ in range(2)]
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        ta.tp_row_reduce(parts, dtype=torch.float16)
    with pytest.raises(ValueError, match='bias'):
        ta.tp_row_reduce(parts, [torch.ones(7, device=dev)] * 2)
    with pytest.raises(ValueError, match='residual'):
        ta.tp_row_reduce(parts, None, [torch.ones(4, 8, device=dev)] * 2, torch.bfloat16)
    with pytest.raises(ValueError, match='residual for 2 ranks'):
        ta.tp_row_reduce(parts, None, [torch.ones(4, 8, device=dev)])


def test_tp_row_reduce_over_two_cards_never_reads_a_reused_partial(dev):
    """Where the host has two or more cards: rank r on cuda:r, each call's
    partials freed right after the sum and their memory refilled with NaN
    on the same streams at once (the caching allocator hands the blocks
    back); no card may read a peer's partial before its card wrote it or
    after it was refilled (the flags across cards), so every output stays
    the plain sum, and a call makes no event call (one device switch a card
    at most)."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards')
    cards = [torch.device('cuda', i) for i in range(2)]
    ta.tp_allreduce([torch.zeros(4, device=c) for c in cards])   # the cards' flags, made once
    gen = torch.Generator().manual_seed(5)
    for trial in range(20):
        host = [torch.randn(3, 385, 256, generator=gen) for _ in cards]
        want = ta.tp_allreduce_plain(host)[0]
        parts = [h.to(c) for h, c in zip(host, cards)]
        calls = ta.ordering_calls()
        outs = ta.tp_row_reduce(parts)
        assert ta.ordering_calls() - calls <= len(cards)
        del parts
        junk = [torch.full((3, 385, 256), float('nan'), device=c) for c in cards]
        for c in cards:
            torch.cuda.synchronize(c)
        assert all(torch.equal(o.cpu(), want) for o in outs), trial
        del junk


def tp_inputs(dev, mp, fmt, dtype, hd, rows, K=1, L=2, h=4, ttm=24, pm=16, S=96):
    """A stack split over mp virtual ranks on ``dev`` (int4: the ranked
    packing), each rank's cache of its local heads, x, lengths."""
    weights, cache_fmt = TP_FORMATS[fmt]
    d = h * hd
    gen = torch.Generator().manual_seed(rows + hd + mp)
    p = transformer_init(gen, L, d, h, 4 * d, adaptive_norm=False)
    mesh = make_model_mesh(mp, [dev] * mp)
    trees = shard_stack(p, mesh, dtype, weights == 'int4')
    caches = []
    for _ in range(mp):
        ck, cv = (torch.randn(L, rows, S, d // mp, generator=gen) for _ in range(2))
        if cache_fmt == 'int8':
            (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, h // mp) for c in (ck, cv))
            caches.append(KVCache(*(t.to(dev) for t in (kq, vq, ks, vs))))
        else:
            caches.append(KVCache(ck.to(dev, dtype), cv.to(dev, dtype)))
    x = torch.randn(rows, K, d, generator=gen).to(dev, dtype)
    rs = np.random.RandomState(rows)
    lens = [torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (rs.randint(0, ttm + 1, rows), rs.randint(1, pm + 1, rows))]
    index = torch.tensor(rs.randint(ttm + pm, S - K + 1, rows), dtype=torch.int32, device=dev)
    return mesh, trees, caches, x, lens, ttm, pm, index


def tp_values(cache, h):
    """A rank's fused (L, rows, S, d / mp) cache as f32 values, int8 or float."""
    if cache.k_scale is None:
        return cache.k.float(), cache.v.float()
    view = fd.per_head_view(cache, h)
    return tuple((c.float() * s.float()).permute(0, 1, 3, 2, 4).flatten(-2)
                 for c, s in ((view.k, view.k_scale), (view.v, view.v_scale)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('chunk', [None, 32], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('step', ['decode', 'decode_per_row', 'verify'])
@pytest.mark.parametrize('fmt', sorted(TP_FORMATS))
@pytest.mark.parametrize('mp', [2, 4])
def test_tp_steps_match_plain(dev, mp, fmt, step, chunk, hd, dtype):
    """The TP decode / verify step (one host call, a stream per rank, 5c
    between the layers) against its plain version (the rank-ordered sum) on
    the same inputs: y within tolerance and bit-equal on every rank, every
    rank's cache written as the plain version writes it, the launch counted
    once."""
    K = 3 if step == 'verify' else 1
    mesh, trees, caches, x, (tl, cl), ttm, pm, index = tp_inputs(dev, mp, fmt, dtype, hd, 5, K)
    if step == 'decode':
        index = ttm + pm + 7
    name = 'fused_verify_step_tp' if step == 'verify' else 'fused_decode_step_tp'
    fn = fd.fused_verify_step if step == 'verify' else fd.fused_decode_step
    c_k = [KVCache(*(t.clone() for t in c if t is not None)) for c in caches]
    c_p = [KVCache(*(t.clone() for t in c if t is not None)) for c in caches]
    before = fd.TP_COUNTERS[name].count
    ys, out = fn(None, x, 4 // mp, None, index, tl, cl, ttm, pm, chunk_override=chunk,
                 tp=(mesh, trees, c_k))
    assert fd.TP_COUNTERS[name].count == before + 1 and out is c_k
    ys_ref, _ = fd._step_plain_tp(name, trees, [x] * mp, 4 // mp, c_p, index, tl, cl, ttm, pm,
                                  chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    tol = TOL[dtype] if dtype == torch.bfloat16 or not fmt.endswith('kv8') else TOL_KV8
    torch.testing.assert_close(ys[0].float(), ys_ref[0].float(), **tol)
    for a, b in zip(c_k, c_p):
        if a.k_scale is not None and dtype == torch.float32:
            assert max(int((u.int() - v.int()).abs().max()) for u, v in zip(a[:2], b[:2])) <= 1
        else:     # values: a float cache, or bf16 codes (their own rounding) times scales
            for u, v in zip(tp_values(a, 4 // mp), tp_values(b, 4 // mp)):
                torch.testing.assert_close(u, v, **tol)


def test_tp_step_refuses_w8a8_and_a_cpu_mix(dev):
    mesh, trees, caches, x, (tl, cl), ttm, pm, _ = tp_inputs(dev, 2, 'dense', torch.float32,
                                                             32, 3)
    q8 = [tq.quantize_transformer(t, bits=8) for t in trees]
    with pytest.raises(ValueError, match='int8 W8A8'):
        fd.fused_decode_step(None, x, 2, None, ttm + pm, tl, cl, ttm, pm,
                             tp=(mesh, q8, caches))
    with pytest.raises(ValueError, match='mesh has 2 ranks'):
        fd.fused_decode_step(None, x, 2, None, ttm + pm, tl, cl, ttm, pm,
                             tp=(mesh, trees[:1], caches))
    with pytest.raises(ValueError, match='one contiguous CUDA float32'):
        ta.tp_allreduce([torch.ones(4, device=dev), torch.ones(4)])


def test_tp_greedy_decode_through_the_kernels_equals_solo(dev):
    """ValleAR on a mesh of two virtual ranks (TP steps, the prefill's 5c)
    gives the solo model's greedy ids, beams and speculative."""
    from valle2_tpu_torch.models.ar import ValleAR
    for extra in ({}, dict(num_beams=1, speculative_k=3, speculative_ngram=2)):
        cfg = ConfigValle(d_model=128, n_heads=4, dim_feedforward=256, num_layers=2,
                          max_audio_len=24, temperature=0.0, matmul_precision='highest',
                          kv_cache_dtype='float32', **extra)
        solo = ValleAR(cfg, device=dev, seed=4)
        tp = ValleAR(cfg, params=solo.params, mesh=make_model_mesh(2, [dev] * 2))
        rs = np.random.RandomState(2)
        toks = [rs.randint(0, cfg.vocab_size, n) for n in (9, 14)]
        pcs = [rs.randint(0, cfg.num_audio_tokens, (n, 8)) for n in (20, 11)]
        before = fd.TP_COUNTERS['fused_decode_step_tp'].count + \
            fd.TP_COUNTERS['fused_verify_step_tp'].count
        got, want = tp.generate_batch(toks, pcs), solo.generate_batch(toks, pcs)
        assert fd.TP_COUNTERS['fused_decode_step_tp'].count + \
            fd.TP_COUNTERS['fused_verify_step_tp'].count > before
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tp_over_two_real_cards_equals_virtual_ranks(dev):
    """Where the host has two or more cards: 5c and the TP decode step with
    rank r on cuda:r (peer reads over NVLink) equal the virtual ranks of one
    card bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards')
    cards = [torch.device('cuda', i) for i in range(2)]
    parts = [torch.randn(7, 64, device=c) for c in cards]
    got = ta.tp_allreduce(parts)
    want = ta.tp_allreduce_plain([p.to(cards[0]) for p in parts])
    torch.cuda.synchronize()
    assert all(torch.equal(g.to(cards[0]), want[0]) for g in got)
    mesh, trees, caches, x, (tl, cl), ttm, pm, _ = tp_inputs(dev, 2, 'dense', torch.float32,
                                                             64, 4)
    real = make_model_mesh(2, cards)
    r_trees = [map_tree(lambda a, c=c: a.to(c), t) for t, c in zip(trees, cards)]
    r_caches = [KVCache(*(t.to(c, copy=True) for t in cache if t is not None))
                for cache, c in zip(caches, cards)]
    ys_v, _ = fd.fused_decode_step(None, x, 2, None, ttm + pm, tl, cl, ttm, pm,
                                   tp=(mesh, trees, caches))
    ys_r, _ = fd.fused_decode_step(None, x, 2, None, ttm + pm, tl, cl, ttm, pm,
                                   tp=(real, r_trees, r_caches))
    torch.cuda.synchronize()
    assert all(torch.equal(y.to(cards[0]), ys_v[0]) for y in ys_r)
    for a, b in zip(r_caches, caches):
        assert torch.equal(a.k.to(cards[0]), b.k)


# --- The persistent TP step: one cooperative launch per card a step, 5c inside ---

def tp_twin_case(dev, mp, fmt, step, dtype, hd, devices=None):
    """A TP case's inputs (``tp_inputs``, 5 rows; verify blocks of K =
    int(step[-1]) tokens) on a mesh of ``devices`` (default: mp virtual ranks
    on ``dev``), with its index and the step's name, wrapper and kwargs."""
    K = int(step.removeprefix('verify')) if step.startswith('verify') else 1
    mesh, trees, caches, x, (tl, cl), ttm, pm, index = tp_inputs(dev, mp, fmt, dtype, hd, 5, K)
    if devices is not None:
        mesh = make_model_mesh(mp, devices)
        trees = [map_tree(lambda a, c=c: a.to(c), t) for t, c in zip(trees, mesh.devices)]
        caches = [KVCache(*(t.to(c) for t in cache if t is not None))
                  for cache, c in zip(caches, mesh.devices)]
    if step == 'decode':
        index = ttm + pm + 7
    name = 'fused_verify_step_tp' if K > 1 else 'fused_decode_step_tp'
    return mesh, trees, caches, x, index, (tl, cl, ttm, pm), name


def twin_caches(caches):
    return [KVCache(*(t.clone() for t in c if t is not None)) for c in caches]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 128])
@pytest.mark.parametrize('chunk', [None, 32], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('step', ['decode', 'decode_per_row', 'verify2', 'verify4', 'verify8'])
@pytest.mark.parametrize('fmt', sorted(TP_FORMATS))
@pytest.mark.parametrize('mp', [2, 4])
def test_tp_persistent_step_equals_the_phased_twin(dev, mp, fmt, step, chunk, hd, dtype):
    """The persistent TP step (one cooperative launch holding the mp virtual
    ranks, 5c's element in its reduce phases) against its phased twin
    (``fused_step_tp_phased``: a kernel per phase, 5c between) on the same
    inputs: every rank's y and every rank's whole cache bit for bit, in every
    weight x cache format, whole-S and chunked, with the scalar and the
    per-row index and verify blocks of 2, 4 and 8 tokens; each launch counted
    once on its own counter."""
    mesh, trees, caches, x, index, args, name = tp_twin_case(dev, mp, fmt, step, dtype, hd)
    c_p, c_t = twin_caches(caches), twin_caches(caches)
    before, phased = fd.TP_COUNTERS[name].count, fd.TP_PHASED_COUNTER.count
    ys, out = fd.fused_step_tp(name, mesh, trees, c_p, x, 4 // mp, index, *args,
                               chunk_override=chunk)
    ys_t, _ = fd.fused_step_tp_phased(name, mesh, trees, c_t, x, 4 // mp, index, *args,
                                      chunk_override=chunk)
    torch.cuda.synchronize()
    assert out is c_p
    assert fd.TP_COUNTERS[name].count == before + 1
    assert fd.TP_PHASED_COUNTER.count == phased + 1
    for y, y_t in zip(ys, ys_t):
        assert torch.equal(y, y_t), (y.float() - y_t.float()).abs().max()
    for a, b in zip(c_p, c_t):
        assert all(torch.equal(u, v) for u, v in zip(a, b) if u is not None)


def test_tp_persistent_step_repeats_bit_for_bit(dev):
    """Two persistent TP steps on the same inputs give the same bits, and a
    third on the outputs of the first continues as the phased twin does:
    the partial planes are re-read every layer, never stale."""
    mesh, trees, caches, x, index, args, name = tp_twin_case(dev, 2, 'dense', 'verify4',
                                                            torch.float32, 64)
    c_a, c_b, c_t = twin_caches(caches), twin_caches(caches), twin_caches(caches)
    ys_a, _ = fd.fused_step_tp(name, mesh, trees, c_a, x, 2, index, *args)
    ys_b, _ = fd.fused_step_tp(name, mesh, trees, c_b, x, 2, index, *args)
    ys_t, _ = fd.fused_step_tp_phased(name, mesh, trees, c_t, x, 2, index, *args)
    nxt = (ys_a[0] * 0.5).contiguous()
    ys_a2, _ = fd.fused_step_tp(name, mesh, trees, c_a, nxt, 2, index + 4, *args)
    ys_t2, _ = fd.fused_step_tp_phased(name, mesh, trees, c_t, nxt, 2, index + 4, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ys_a, ys_b))
    assert all(torch.equal(a, t) for a, t in zip(ys_a, ys_t))
    assert all(torch.equal(a, t) for a, t in zip(ys_a2, ys_t2))


TP_PROFILE = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as t
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from valle2_tpu_torch.kernels import fused_decode as fd
dev = torch.device('cuda')
mesh, trees, caches, x, index, args, name = t.tp_twin_case(dev, 2, 'kv8', sys.argv[2],
                                                          torch.bfloat16, 64)
run = lambda: fd.fused_step_tp(name, mesh, trees, caches, x, 2, index, *args, chunk_override=32)
run()
torch.cuda.synchronize()
seen = []
for _ in range(3):
    before = fd.TP_COUNTERS[name].count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not any(w in e.name.lower() for w in ('sleep', 'spin'))]
    seen.append(dict(launches=fd.TP_COUNTERS[name].count - before, names=names))
    if len(names) == 3:
        break
print('PROFILE ' + json.dumps(seen), flush=True)
"""


@pytest.mark.parametrize('step', ['decode', 'verify4'])
def test_tp_persistent_step_is_one_device_kernel(dev, step):
    """torch.profiler: three TP steps of two virtual ranks on one card (int8
    cache, chunked) run three device kernels, each the persistent TP step:
    no phased step kernel and no 5c launch.  Profiled in a process of its
    own: late in a long pytest process torch.profiler has kept one device
    kernel of several back-to-back launches, where a fresh process sees them
    all.  A profile that saw fewer (lost records) is taken again, up to
    three times, and one must see exactly three; a kernel of another name,
    or more than three, fails."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, '-c', TP_PROFILE, str(here), step],
                         capture_output=True, text=True, timeout=300, cwd=here.parent)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith('PROFILE ')), None)
    assert line is not None, out.stderr[-3000:]
    seen = json.loads(line.removeprefix('PROFILE '))
    for attempt in seen:
        assert attempt['launches'] == 3
        names = attempt['names']
        assert len(names) <= 3 and all('step_tp_persistent_kernel' in n for n in names), names
    assert len(seen[-1]['names']) == 3, seen


@pytest.mark.parametrize('mp', [2, 4])
@pytest.mark.parametrize('dims', [(256, 4, 1024), (1024, 16, 4096)], ids=['serving', 'w204m'])
@pytest.mark.parametrize('layout', ['w', 'q4'])
def test_tp_persistent_grid_matches_the_plan(dev, layout, dims, mp):
    """The TP launcher's grid fills the card (SM count x blocks per SM) and
    its shared memory is the plan's (``tp_persistent_plan``)."""
    d, h, dff = dims
    blocks, smem = fd.step_grid(torch.bfloat16, torch.bfloat16, layout, d // h, d, dff // mp,
                                da=d // mp)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert blocks >= sms and blocks % sms == 0
    plan = fd.tp_persistent_plan(2, 8, d, dff, h, 128, 128, layout, devices=[dev] * mp)
    assert smem == plan['smem_bytes'] and plan['launches'] == 1


def test_tp_persistent_step_refuses_w8a8(dev):
    """int8 W8A8 weights are refused by both TP routes (a global activation
    amax would be needed inside the step), and W8A8 has no TP build: its
    sizing raises."""
    mesh, trees, caches, x, index, args, name = tp_twin_case(dev, 2, 'dense', 'decode',
                                                            torch.float32, 32)
    q8 = [tq.quantize_transformer(t, bits=8) for t in trees]
    for fn in (fd.fused_step_tp, fd.fused_step_tp_phased):
        with pytest.raises(ValueError, match='int8 W8A8'):
            fn(name, mesh, q8, caches, x, 2, index, *args)
    with pytest.raises(ValueError, match='W8A8'):
        fd.step_grid(torch.float32, torch.float32, 'q', 32, 128, 256, da=64)


@pytest.mark.parametrize('layout', ['two_cards', 'mixed'])
def test_tp_persistent_step_across_cards_equals_the_phased_twin(dev, layout):
    """Where the host has two or more cards: the persistent TP step with its
    barriers across cards (flags in peer memory), rank r on cuda:r
    ('two_cards', mp 2: two launches of one rank) or ranks 0, 1 on cuda:0
    and 2, 3 on cuda:1 ('mixed', mp 4: two launches of two ranks), against
    its phased twin and the virtual ranks of one card bit for bit, three
    steps in a row."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards')
    cards = ['cuda:0', 'cuda:1'] if layout == 'two_cards' else ['cuda:0'] * 2 + ['cuda:1'] * 2
    mp = len(cards)
    mesh, trees, caches, x, index, args, name = tp_twin_case(dev, mp, 'dense', 'verify4',
                                                            torch.float32, 64, devices=cards)
    v_mesh, v_trees, v_caches, *_ = tp_twin_case(dev, mp, 'dense', 'verify4', torch.float32,
                                                 64)
    plan = fd.tp_persistent_plan(2, 5, 256, 1024, 4, 96, 96, q_len=4, devices=cards)
    assert plan['launches'] == 2 and plan['grid_syncs'] == plan['barriers'] + 4
    c_p, c_t, c_v = twin_caches(caches), twin_caches(caches), twin_caches(v_caches)
    for step in range(3):
        at = index + 4 * step
        ys, _ = fd.fused_step_tp(name, mesh, trees, c_p, x, 4 // mp, at, *args)
        ys_t, _ = fd.fused_step_tp_phased(name, mesh, trees, c_t, x, 4 // mp, at, *args)
        ys_v, _ = fd.fused_step_tp(name, v_mesh, v_trees, c_v, x, 4 // mp, at, *args)
        torch.cuda.synchronize()
        for y, y_t in zip(ys, ys_t):
            assert torch.equal(y, y_t)
        assert all(torch.equal(y.to(dev), ys_v[0]) for y in ys)
    for a, b, v in zip(c_p, c_t, c_v):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        assert torch.equal(a.k.to(dev), v.k)


def test_tp_wait_across_cards_is_bounded(dev):
    """A barrier across cards whose peer never launches ends in an error,
    not a hang: in a process of its own (the trap loses its CUDA context),
    ``valle2_tp_wait_probe`` waits for a second card that never comes; after
    about 10 s the waiting thread sets the host-mapped error word and traps,
    and the process's next synchronize raises."""
    import subprocess
    import sys
    from pathlib import Path
    code = (
        'import ctypes, time, torch\n'
        'from valle2_tpu_torch.kernels import _build\n'
        "lib = _build.load('fused_step_tp_dense')\n"
        'lib.valle2_tp_wait_probe.argtypes = [ctypes.c_void_p]\n'
        't0 = time.perf_counter()\n'
        'status = lib.valle2_tp_wait_probe(torch.cuda.current_stream().cuda_stream)\n'
        "err = 'none'\n"
        'try:\n'
        '    torch.cuda.synchronize()\n'
        'except RuntimeError as e:\n'
        "    err = 'raised'\n"
        "print('PROBE', status, err, lib.valle2_tp_timed_out(), "
        'round(time.perf_counter() - t0, 1), flush=True)\n')
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=180, cwd=root)
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith('PROBE'))
    _, status, err, timed_out, secs = line.split()
    assert (status, err, timed_out) == ('0', 'raised', '1'), out.stderr[-2000:]
    assert 9.5 <= float(secs) < 60


def test_reference_checkpoint_round_trip_greedy_equals_in_memory(dev, tmp_path):
    """A reference-format checkpoint (Lightning layout, 'model.' prefix)
    written by save_torch_checkpoint and read by load_torch_checkpoint onto
    the card: params bit-equal, and greedy codes through #1 and #6 equal the
    in-memory model's."""
    from valle2_tpu_torch.models import ValleAR, ValleNAR
    from valle2_tpu_torch.models.convert import load_torch_checkpoint, save_torch_checkpoint
    from valle2_tpu_torch.tts import ValleTTS
    cfg = ConfigValle(d_model=128, n_heads=4, dim_feedforward=256, num_layers=2,
                      max_audio_len=24, temperature=0.0, ignore_eos=True,
                      matmul_precision='highest', kv_cache_dtype='float32')
    mem = ValleTTS(cfg, ar=ValleAR(cfg, seed=3, device=dev), nar=ValleNAR(cfg, seed=4, device=dev),
                   device=dev)
    loaded = {}
    for model, params in (('ValleAR', mem.ar.params), ('ValleNAR', mem.nar.params)):
        save_torch_checkpoint(tmp_path / 'x.ckpt', params, model)
        sd = torch.load(tmp_path / 'x.ckpt', weights_only=True)['state_dict']
        torch.save({'state_dict': {f'model.{k}': v for k, v in sd.items()}}, tmp_path / 'x.ckpt')
        loaded[model] = load_torch_checkpoint(tmp_path / 'x.ckpt', model, num_layers=2,
                                              device=dev)
        got, want = [], []
        map_tree(got.append, loaded[model])
        map_tree(want.append, params)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    disk = ValleTTS(cfg, ar=ValleAR(cfg, params=loaded['ValleAR'], device=dev),
                    nar=ValleNAR(cfg, params=loaded['ValleNAR'], device=dev), codec=mem.codec,
                    device=dev)
    rs = np.random.RandomState(8)
    reqs = [(f'request {i}.', rs.randint(0, 70, (5,)), rs.randint(0, 1024, (6, 8)))
            for i in range(3)]
    want = mem.batch_synthesize(*map(list, zip(*reqs)))
    before = (fa.COUNTER.count, fd.COUNTER.count, fd.PLAIN_CALLS.count)
    got = disk.batch_synthesize(*map(list, zip(*reqs)))
    assert fa.COUNTER.count > before[0] and fd.COUNTER.count > before[1]
    assert fd.PLAIN_CALLS.count == before[2]
    assert all(np.array_equal(g.codes, w.codes) for g, w in zip(got, want))


@pytest.mark.parametrize('mode', ['compile', 'aot'])
def test_cold_start_loads_every_library_from_disk(dev, tmp_path, mode):
    """A fresh coldstart_bench process over built libraries (the build
    directory, or an AOT directory filled from it) builds nothing and loads
    each library its first request launches from disk."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from valle2_tpu_torch.kernels import _build
    _build.build_all()
    root = Path(__file__).resolve().parents[1]
    cfg = tmp_path / 'cfg.json'
    cfg.write_text(json.dumps(dict(d_model=128, n_heads=4, dim_feedforward=256, num_layers=2,
                                   max_audio_len=16, dtype='bfloat16')))
    extra = []
    if mode == 'aot':
        aot = tmp_path / 'aot'
        aot.mkdir()
        for n in _build.BUILDS:
            shutil.copy(_build._lib_path(n), aot)
        extra = ['--aot-cache', str(aot)]
    r = subprocess.run([sys.executable, '-m', 'valle2_tpu_torch.tools.coldstart_bench', mode,
                        '-c', str(cfg), *extra], cwd=root, capture_output=True, text=True,
                       timeout=600, env={**os.environ, 'PYTHONPATH': str(root)})
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line['aot_compiles'] == 0 and line['aot_fallbacks'] == 0
    assert line['aot_disk_loads'] >= 2             # #1 and the persistent #6
    assert line['first_request_s'] > 0


@pytest.mark.parametrize('frames', [64, 640], ids=['fused_bwd_s80', 'split_bwd_s800'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_remat_grads_through_the_kernels_equal_without(dev, dtype, frames):
    """An AR loss with dropout 0.1 through #1 and #3 (s=80) or #4 + #5
    (s=800 > FUSED_BWD_MAX_SEQ) with remat: the loss bit-equal to the plain
    stack's, every grad bit-equal where a second plain run repeats bit for
    bit (else within 1e-4 in f32 / 16 bf16 ulps in bf16 of the leaf's
    largest |grad|: #3's dq sums through atomics), #1 launched twice a layer and the
    backward kernels once a layer, as without remat."""
    import dataclasses

    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.train import init_state, step_generator, tree_leaves
    cfg = ConfigValle(d_model=128, n_heads=2, dim_feedforward=256, num_layers=2, dropout=0.1,
                      dtype=dtype, matmul_precision='highest', use_flash_attention=True)
    rs = np.random.RandomState(frames)
    b, tt = 2, frames // 4
    batch = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in {
        'tokens': rs.randint(0, 256, (b, tt)), 'tokens_lens': [tt, tt - 3],
        'codes': rs.randint(0, 1026, (b, frames)), 'target': rs.randint(0, 1025, (b, frames)),
        'codes_lens': [frames, frames - 7]}.items()}
    counters = (fa.COUNTER, fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER)
    with torch.inference_mode(False), torch.enable_grad():
        params = init_state(cfg, 'ValleAR', device=dev).params
        leaves = tree_leaves(params)

        def run(remat):
            before = [c.count for c in counters]
            c = dataclasses.replace(cfg, remat=remat)
            with precision_scope(c):
                loss, _ = ar_mod.loss_fn(params, c, batch, step_generator(2, 0, dev))
                grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            return loss.detach(), grads, [c.count - n for c, n in zip(counters, before)]
        plain, remat, again = run(False), run(True), run(False)
    assert torch.equal(plain[0], remat[0]) and torch.isfinite(plain[0])
    tol = 1e-4 if dtype == 'float32' else 16 * 2.0 ** -8
    repeats = all(torch.equal(a, w) for a, w in zip(again[1], plain[1]))
    for g, w in zip(remat[1], plain[1]):
        if repeats:
            assert torch.equal(g, w)
        else:
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
    L = cfg.num_layers
    split = frames + tt > fa.FUSED_BWD_MAX_SEQ
    assert plain[2] == [L, 0, L, L] if split else plain[2] == [L, L, 0, 0]
    assert remat[2] == [2 * L, *plain[2][1:]]
