"""The host-side plan of the persistent fused steps (#6 and the
speculative verify step #7, each one cooperative launch a step):
``kernels.fused_decode.persistent_plan`` and its parts, which say what one
launch does and how much shared memory a block takes.  The launcher
(csrc/fused_step.cu ``step_persistent``) sizes itself the same way; on the
card tests/test_torch_cuda.py holds the two equal (``step_grid``) and both
steps bit for bit against the phased twin (``fused_verify_step_phased``).
Here: the plan's counts at the serving and 204M widths, for #6 and for #7's
verify blocks (3 rows x K = 4 and 1 x 4; the int8 cache's extra phase); the
projection tile's switch to 8 rows; the shared memory of every stack the
kernels take fits a block; the plan's constants are the kernel source's;
and on CPU tensors the phased twin is the plain version."""

import re
from pathlib import Path

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch import quantize as tq
from valle2_tpu_torch.kernels import fused_decode as fd
from valle2_tpu_torch.ops.transformer import KVCache, transformer_init

SOURCE = Path(fd.__file__).resolve().parents[1] / 'csrc' / 'fused_decode.cuh'


def test_plan_at_the_serving_and_204m_widths():
    """The serving model (12 rows, d 256, 4 heads, dff 1024, 8 layers, a bf16
    cache of 1280 slots in chunks of 640) and the 204M stack (one row, d
    1024, 16 heads, dff 4096, 16 layers, 896 slots whole)."""
    serve = fd.persistent_plan(8, 12, 256, 1024, 4, 1280, 640)
    assert serve['items'] == {'qkv': 24, 'attention': 96, 'out': 8, 'ffn1': 32, 'ffn2': 8}
    assert serve['barriers'] == 39 and serve['launches'] == 1
    assert serve['threads'] == 512
    assert serve['smem_bytes'] == 4 * (16 * 1024 + 16 * 16 * 32)
    large = fd.persistent_plan(16, 1, 1024, 4096, 16, 896, 896)
    assert large['items'] == {'qkv': 96, 'attention': 16, 'out': 32, 'ffn1': 128, 'ffn2': 32}
    assert large['barriers'] == 79
    # FFN2's 4096-wide input takes the 8-row tile
    assert fd.proj_tile_rows(4096, 'w') == 8 and fd.proj_tile_rows(1024, 'w') == 16
    assert large['smem_bytes'] == 4 * (8 * 4096 + 16 * 8 * 32)


@pytest.mark.parametrize('layout,k16', [('w', 3072), ('q', 2048), ('q4', 3072)])
def test_projection_tile_rows_switch_at_the_shared_memory_limit(layout, k16):
    assert fd.proj_tile_rows(k16, layout) == 16
    assert fd.proj_tile_rows(k16 + 8, layout) == 8
    assert fd.proj_smem_bytes(k16, layout) <= fd.SMEM_OPT_IN


@pytest.mark.parametrize('layout', ['w', 'q', 'q4'])
def test_plan_fits_every_stack_the_kernels_take(layout):
    """Every width that ``fit_error`` lets through has a persistent step
    whose block fits the shared memory it can opt into."""
    taken = 0
    for hd in fd.HEAD_DIMS:
        for heads in (1, 2, 4, 8, 16, 24, 32, 48):
            d = hd * heads
            for dff in (d, 2 * d, 4 * d, 4096, 6144):
                if fd.fit_error(d, heads, dff, layout) is not None:
                    continue
                plan = fd.persistent_plan(2, 12, d, dff, heads, 256, 128, layout)
                assert plan['smem_bytes'] <= fd.SMEM_OPT_IN
                taken += 1
    assert taken > 20


def test_plan_refuses_heads_that_do_not_split_d():
    with pytest.raises(ValueError, match='heads'):
        fd.persistent_plan(2, 4, 250, 1024, 4, 128, 128)


def test_plan_constants_are_the_kernel_sources():
    """The tile constants and phase counts the plan mirrors, read from
    csrc/fused_decode.cuh."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    assert const('NCOL') == fd._NCOL and const('KSPLIT') == fd._KSPLIT
    assert const('ANW') == fd._ANW
    assert const('STEP_PHASES') == len(fd.STEP_PHASES)
    assert const('STEP_PHASES_KVQ') == len(fd.STEP_PHASES_KVQ)
    assert re.search(r'const bool kvq = QUANT && s\.qblk > 1;', src)
    assert re.search(r'const int np = kvq \? STEP_PHASES_KVQ : STEP_PHASES;', src)
    assert re.search(r'constexpr int PNT = NCOL \* KSPLIT;', src)
    assert fd._NCOL * fd._KSPLIT == fd.PERSISTENT_THREADS
    k16 = re.search(r'max_k16\(int wf\) \{ return wf == W8 \? (\d+) : (\d+); \}', src)
    assert (int(k16.group(1)), int(k16.group(2))) == (fd._MAX_K16[1], fd._MAX_K16[0])
    assert fd._MAX_K16[2] == fd._MAX_K16[0]


# #7's verify blocks: (L, rows, K, d, dff, heads, S, chunk) -> the plan's
# items per layer (the int8 cache write's warps apart) -- the serving cell
# (3 rows x K = 4, S 901 whole; the chunked spec run's S 1024 in chunks of
# 512) and the 204M stack (1 row x 4, S 900).
VERIFY_PLANS = {
    'serving': ((8, 3, 4, 256, 1024, 4, 901, 901),
                {'qkv': 24, 'attention': 48, 'out': 8, 'ffn1': 32, 'ffn2': 8}),
    'serving_chunked': ((8, 3, 4, 256, 1024, 4, 1024, 512),
                        {'qkv': 24, 'attention': 96, 'out': 8, 'ffn1': 32, 'ffn2': 8}),
    'w204m': ((16, 1, 4, 1024, 4096, 16, 900, 900),
              {'qkv': 96, 'attention': 64, 'out': 32, 'ffn1': 128, 'ffn2': 32}),
}


@pytest.mark.parametrize('kv8', [False, True], ids=['float_cache', 'int8_cache'])
@pytest.mark.parametrize('shape', sorted(VERIFY_PLANS))
def test_verify_plan_at_the_serving_and_204m_shapes(shape, kv8):
    """rows x K query rows through the projections and the attention; 5
    barriers a layer less the last, 6 with an int8 cache (its write a phase
    of its own, one warp per (query row, head, k|v)); one launch; the
    shared memory of #6's launch, whatever K."""
    (L, rows, K, d, dff, h, S, chunk), items = VERIFY_PLANS[shape]
    plan = fd.persistent_plan(L, rows, d, dff, h, S, chunk, q_len=K, kv8=kv8)
    want = dict(items, kv_quant=rows * K * 2 * h) if kv8 else items
    assert plan['items'] == want
    assert plan['phases'] == (fd.STEP_PHASES_KVQ if kv8 else fd.STEP_PHASES)
    assert plan['barriers'] == (6 * L - 1 if kv8 else 5 * L - 1)
    assert plan['launches'] == 1 and plan['threads'] == 512
    one = fd.persistent_plan(L, rows, d, dff, h, S, chunk, kv8=kv8)
    assert plan['smem_bytes'] == one['smem_bytes']


@pytest.mark.parametrize('layout', ['w', 'q', 'q4'])
def test_a_block_of_one_token_keeps_five_phases(layout):
    """#6 (q_len 1) folds its int8 cache write into the attention: 5 phases a
    layer over any cache, and its plan is the one it had before #7 joined."""
    for kv8 in (False, True):
        plan = fd.persistent_plan(8, 12, 256, 1024, 4, 1280, 640, layout, kv8=kv8)
        assert plan['phases'] == fd.STEP_PHASES and plan['barriers'] == 39
        assert 'kv_quant' not in plan['items']
        assert plan == fd.persistent_plan(8, 12, 256, 1024, 4, 1280, 640, layout, q_len=1)


@pytest.mark.parametrize('K,rows', [(2, 3), (8, 3), (9, 2), (17, 1)])
def test_verify_plan_tiles_count_the_query_rows(K, rows):
    """A block of K tokens on r rows tiles like a step of r K rows: 16-row
    tiles below 3072-wide inputs, 8-row ones above (FFN2 at dff 4096)."""
    plan = fd.persistent_plan(2, rows, 256, 4096, 4, 256, 256, q_len=K)
    step = fd.persistent_plan(2, rows * K, 256, 4096, 4, 256, 256)
    assert plan['items'] == step['items']
    assert plan['items']['qkv'] == 24 * -(-rows * K // 16)
    assert plan['items']['ffn2'] == 8 * -(-rows * K // 8)


def test_plan_refuses_an_empty_block():
    with pytest.raises(ValueError, match='block'):
        fd.persistent_plan(2, 3, 256, 1024, 4, 128, 128, q_len=0)


def phased_twin_inputs(variant, chunk, L=2, rows=3, K=4, h=2, hd=32, ttm=6, pm=8, S=64):
    """A small stack and fused cache of ``variant`` on the CPU (seeded), a
    (rows, K, d) block at distinct per-row start slots (row 1's straddles
    slot 32, row 2's ends at S - 1) and per-row lengths."""
    gen = torch.Generator().manual_seed(len(variant) + (chunk or 0))
    d = h * hd
    p = transformer_init(gen, L, d, h, 4 * d, adaptive_norm=False)
    if variant.startswith(('w8a8', 'w4a16')):
        p = tq.quantize_transformer(p, bits=8 if variant.startswith('w8a8') else 4)
    ck, cv = (torch.randn(L, rows, S, d, generator=gen) for _ in range(2))
    if variant.endswith('kv8'):
        (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, h) for c in (ck, cv))
        cache = KVCache(kq, vq, ks, vs)
    else:
        cache = KVCache(ck, cv)
    x = torch.randn(rows, K, d, generator=gen)
    index = torch.tensor([ttm + pm + 3, 30, S - K], dtype=torch.int32)
    tl = torch.tensor([ttm, 2, 4], dtype=torch.int32)
    cl = torch.tensor([pm, 5, 1], dtype=torch.int32)
    return p, x, cache, index, tl, cl, ttm, pm, h


@pytest.mark.parametrize('chunk', [None, 16], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('variant', fd.VARIANTS)
def test_phased_twin_on_cpu_tensors_is_the_plain_version(variant, chunk):
    """On CPU tensors ``fused_verify_step_phased`` takes the plain version,
    as every wrapper does: y and the updated cache equal
    ``fused_verify_step_plain``'s and ``fused_verify_step``'s bit for bit,
    and no kernel launch is counted (the twin's, #7's or the chunked one)."""
    p, x, cache, index, tl, cl, ttm, pm, h = phased_twin_inputs(variant, chunk)
    assert fd.variant(p, cache) == variant
    counters = (fd.PHASED_COUNTER, *fd.VERIFY_COUNTERS.values(), *fd.CHUNKED_COUNTERS.values())
    before = [c.count for c in counters]
    plain_calls = fd.PLAIN_CALLS.count
    outs = []
    for fn in (fd.fused_verify_step_phased, fd.fused_verify_step_plain, fd.fused_verify_step):
        c = KVCache(*(t.clone() for t in cache if t is not None))
        y, out = fn(p, x, h, c, index, tl, cl, ttm, pm, chunk_override=chunk)
        assert out.k is c.k and y.shape == x.shape and torch.isfinite(y.float()).all()
        outs.append((y, c))
    assert [c.count for c in counters] == before
    assert fd.PLAIN_CALLS.count == plain_calls + 3
    (y0, c0), *rest = outs
    for y, c in rest:
        assert torch.equal(y, y0)
        assert all(torch.equal(a, b) for a, b in zip(c, c0) if a is not None)
    # the block's slots were written
    assert not torch.equal(c0.k[:, 0, index[0]:index[0] + x.shape[1]],
                           cache.k[:, 0, index[0]:index[0] + x.shape[1]])
