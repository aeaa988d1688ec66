"""The host side of the persistent tensor-parallel fused step (#6 and #7
under TP, one cooperative launch per card a step, the all-reduce 5c folded in
as two reduce phases a layer): ``kernels.fused_decode.tp_persistent_plan``
and ``tp_card_groups``, which say what one TP step launches and does; the
constants they mirror, read from ``csrc/fused_decode.cuh`` and
``csrc/fused_step.cu``; the phased twin ``fused_step_tp_phased`` on CPU
tensors, which is the plain TP step (``_step_plain_tp``, held to JAX's
``shard_map`` step by ``tests/test_torch_tp.py``); and that no serving
module calls the twin.  On the card ``tests/test_torch_cuda.py`` holds the
persistent TP step bit for bit against the twin and its grid to the plan."""

import re
from pathlib import Path

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch import quantize as tq
from valle2_tpu_torch.kernels import fused_decode as fd
from valle2_tpu_torch.kernels import tp_allreduce as ta
from valle2_tpu_torch.ops.transformer import KVCache, transformer_init
from valle2_tpu_torch.parallel import make_model_mesh, shard_decode_params, tp_permute_qkv

PKG = Path(fd.__file__).resolve().parents[1]
CUH = PKG / 'csrc' / 'fused_decode.cuh'
STEP_CU = PKG / 'csrc' / 'fused_step.cu'

# The serving stack (12 rows, d 256, 4 heads, dff 1024, 8 layers, S 1280
# whole; the spec cell 3 rows x K = 4) and the 204M stack (4 rows, d 1024,
# 16 heads, dff 4096, 16 layers, S 1024 in chunks of 512): (L, rows, d, dff,
# heads, S, chunk).
WIDTHS = {'serving': (8, 12, 256, 1024, 4, 1280, 1280),
          'spec': (8, 3, 256, 1024, 4, 1024, 1024),
          'w204m': (16, 4, 1024, 4096, 16, 1024, 512)}


@pytest.mark.parametrize('kv8', [False, True], ids=['float_cache', 'int8_cache'])
@pytest.mark.parametrize('q_len', [1, 4], ids=['decode', 'verify4'])
@pytest.mark.parametrize('mp', [2, 4])
@pytest.mark.parametrize('widths', sorted(WIDTHS))
def test_tp_plan_at_the_serving_and_204m_widths(widths, mp, q_len, kv8):
    """Virtual ranks on one card: one launch holding every rank; 7 phases a
    layer (8 for #7 over an int8 cache: its write a phase of its own), a
    grid barrier after each but the last, 2 L of them across ranks (on one
    card only grid barriers); each phase's items the ranks' items summed:
    the projections' tiles at the rank's widths (d / mp attention, dff / mp
    FFN), the attention items over the local heads, the reduce phases' (rows
    x q_len, d) elements of every rank."""
    L, rows, d, dff, h, S, chunk = WIDTHS[widths]
    plan = fd.tp_persistent_plan(L, rows, d, dff, h, S, chunk, q_len=q_len, kv8=kv8,
                                 devices=['cuda:0'] * mp)
    kvq = kv8 and q_len > 1
    assert plan['phases'] == (fd.STEP_PHASES_TP_KVQ if kvq else fd.STEP_PHASES_TP)
    assert len(plan['phases']) == (8 if kvq else 7)
    assert plan['barriers'] == len(plan['phases']) * L - 1 == plan['grid_syncs']
    assert plan['rank_barriers'] == 2 * L
    assert plan['launches'] == 1 and plan['groups'] == [list(range(mp))]
    (launch,) = plan['per_launch']
    assert launch['device'] == 'cuda:0' and launch['ranks'] == list(range(mp))
    qr = rows * q_len
    n_chunks = S // chunk if chunk < S else 1
    da, dffr = d // mp, dff // mp

    def tiles(K, N):
        return -(-N // 32) * -(-qr // fd.proj_tile_rows(K, 'w'))
    want = {'qkv': tiles(d, 3 * da), 'attention': qr * (h // mp) * n_chunks,
            'out': tiles(da, d), 'reduce_out': qr * d, 'ffn1': tiles(d, dffr),
            'ffn2': tiles(dffr, d), 'reduce_ffn2': qr * d}
    if kvq:
        want['kv_quant'] = qr * 2 * (h // mp)
    assert launch['items'] == {k: mp * n for k, n in want.items()}
    assert plan['threads'] == fd.PERSISTENT_THREADS


def test_tp_plan_counts_at_the_serving_width():
    """Two virtual ranks of the serving step (12 rows, S 1280 whole): the
    numbers the kernel walks, written out."""
    plan = fd.tp_persistent_plan(8, 12, 256, 1024, 4, 1280, 1280, devices=['cuda:0'] * 2)
    assert plan['per_launch'][0]['items'] == {
        'qkv': 24, 'attention': 48, 'out': 16, 'reduce_out': 2 * 12 * 256, 'ffn1': 32,
        'ffn2': 16, 'reduce_ffn2': 2 * 12 * 256}
    assert plan['barriers'] == 55 and plan['rank_barriers'] == 16
    # a rank's widest projection input is FFN2's dff / mp = 512: a 16-row tile
    assert plan['smem_bytes'] == fd.proj_smem_bytes(512, 'w')


@pytest.mark.parametrize('devices,groups', [
    (['cuda:0'] * 4, [[0, 1, 2, 3]]),
    ([f'cuda:{i}' for i in range(4)], [[0], [1], [2], [3]]),
    (['cuda:0', 'cuda:0', 'cuda:1', 'cuda:1'], [[0, 1], [2, 3]]),
    (['cuda:1', 'cuda:0', 'cuda:1', 'cuda:0'], [[0, 2], [1, 3]]),
    ([torch.device('cuda', 0), torch.device('cuda:0')], [[0, 1]]),
    (['cpu'] * 2, [[0, 1]]),
], ids=['virtual', 'four_cards', 'mixed', 'interleaved', 'device_objects', 'cpu'])
def test_tp_card_groups(devices, groups):
    """Ranks grouped by device in the order each device first appears, each
    group in rank order: one launch per group (``torch.device`` objects need
    no card)."""
    assert fd.tp_card_groups(devices) == groups
    plan = fd.tp_persistent_plan(2, 4, 128, 512, 4, 64, 64, devices=devices)
    assert plan['groups'] == groups and plan['launches'] == len(groups)
    assert [g['ranks'] for g in plan['per_launch']] == groups
    one = fd.tp_persistent_plan(2, 4, 128, 512, 4, 64, 64, devices=['cuda:0'] * len(devices))
    for g in plan['per_launch']:     # a launch's items: its ranks' share
        assert g['items'] == {k: n * len(g['ranks']) // len(devices)
                              for k, n in one['per_launch'][0]['items'].items()}
    # across cards the barriers across ranks add a wait and a second grid barrier
    extra = 2 * 2 if len(groups) > 1 else 0
    assert plan['grid_syncs'] == plan['barriers'] + extra


@pytest.mark.parametrize('layout', ['w', 'q4'])
@pytest.mark.parametrize('mp', [2, 4])
def test_tp_plan_fits_every_stack_the_kernels_take(layout, mp):
    """Every width ``fit_error`` lets through at mp ranks has a TP step whose
    block fits the shared memory it can opt into, the rank's d / mp-wide
    attention input included."""
    taken = 0
    for hd in fd.HEAD_DIMS:
        for heads in (4, 8, 16, 24, 32, 48):
            d = hd * heads
            for dff in (d, 4 * d, 4096, 8192, 12288):
                if fd.fit_error(d, heads, dff, layout, mp) is not None:
                    continue
                plan = fd.tp_persistent_plan(2, 12, d, dff, heads, 256, 128, layout,
                                             devices=['cuda:0'] * mp)
                assert plan['smem_bytes'] <= fd.SMEM_OPT_IN
                assert plan['smem_bytes'] >= fd.proj_smem_bytes(d // mp, layout)
                taken += 1
    assert taken > 20


def test_tp_plan_refuses_what_does_not_split():
    with pytest.raises(ValueError, match='split over 3'):
        fd.tp_persistent_plan(2, 4, 256, 1024, 4, 128, 128, devices=['cuda:0'] * 3)
    with pytest.raises(ValueError, match='block'):
        fd.tp_persistent_plan(2, 4, 256, 1024, 4, 128, 128, q_len=0)


def test_tp_plan_constants_are_the_kernel_sources():
    """The phase counts, rank limit, pointer count and the wait across cards
    the host mirrors, read from csrc/fused_decode.cuh and csrc/fused_step.cu:
    the TP kernel's two barriers across ranks a layer, each after the
    partial it guards (OUT, FFN2) and before its reduce."""
    src = CUH.read_text()

    def const(name, text=src):
        return int(re.search(rf'constexpr (?:int|unsigned long long) {name} = (\d+)',
                             text).group(1))
    assert const('STEP_PHASES_TP') == len(fd.STEP_PHASES_TP)
    assert const('STEP_PHASES_TP_KVQ') == len(fd.STEP_PHASES_TP_KVQ)
    assert const('MAX_MP') == ta.MAX_MP == 8
    assert const('TP_PTRS') == 32
    assert const('CARD_WAIT_NS') == 10 ** 10
    assert re.search(r'const int np = kvq \? STEP_PHASES_TP_KVQ : STEP_PHASES_TP;', src)
    body = src[src.index('step_tp_persistent_kernel(TpStepArgs p)'):]
    body = body[:body.index('\n}\n')]
    calls = re.findall(r'(run_proj<T, T, (?:OUT|FFN2), WF>|rank_barrier\(k\+\+\)|'
                       r'run_reduce<T, EPI_(?:OUT|FFN2)>)', body)
    assert calls == ['run_proj<T, T, OUT, WF>', 'rank_barrier(k++)', 'run_reduce<T, EPI_OUT>',
                     'run_proj<T, T, FFN2, WF>', 'rank_barrier(k++)',
                     'run_reduce<T, EPI_FFN2>']
    # 5c alone and the TP step's reduce phases share one element function
    assert 'reduce_element<T, EPI>(src, mp, i, d, bias, x, res32, out32, y)' in \
        (PKG / 'csrc' / 'fused_decode.cu').read_text()
    step = STEP_CU.read_text()
    assert 'g_epoch += 2ull * s[0].L' in step


L, D, H, DFF = 2, 64, 4, 128


def tp_case(mp, q_len, int8):
    """A tiny stack split over mp CPU ranks, each rank's fused cache of its
    local heads, and a block of q_len tokens at per-row slots."""
    gen = torch.Generator().manual_seed(17 + mp + q_len)
    p = transformer_init(gen, L, D, H, DFF, adaptive_norm=False)
    trees = shard_decode_params(tp_permute_qkv(p, mp), mp)
    rows, S, ttm, pm = 3, 40, 6, 8
    caches = []
    for _ in range(mp):
        ck, cv = (torch.randn(L, rows, S, D // mp, generator=gen) for _ in range(2))
        if int8:
            (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, H // mp) for c in (ck, cv))
            caches.append(KVCache(kq, vq, ks, vs))
        else:
            caches.append(KVCache(ck, cv))
    x = torch.randn(rows, q_len, D, generator=gen)
    index = torch.tensor([ttm + pm + 2, ttm + pm + 9, S - q_len], dtype=torch.int32)
    lens = (torch.tensor([ttm, 3, 5], dtype=torch.int32),
            torch.tensor([pm, 2, 7], dtype=torch.int32))
    return make_model_mesh(mp, ['cpu'] * mp), trees, caches, x, index, lens, ttm, pm


@pytest.mark.parametrize('int8', [False, True], ids=['f32_cache', 'int8_cache'])
@pytest.mark.parametrize('chunk', [None, 8], ids=['whole_s', 'chunked'])
@pytest.mark.parametrize('q_len', [1, 3], ids=['decode', 'verify'])
@pytest.mark.parametrize('mp', [2, 4])
def test_tp_phased_twin_on_cpu_tensors_is_the_plain_step(mp, q_len, chunk, int8):
    """On CPU tensors ``fused_step_tp_phased`` and ``fused_step_tp`` both take
    ``_step_plain_tp``: every rank's y and cache equal its bit for bit, equal
    across ranks, and no launch is counted (the TP steps', the twin's)."""
    name = 'fused_verify_step_tp' if q_len > 1 else 'fused_decode_step_tp'
    mesh, trees, caches, x, index, (tl, cl), ttm, pm = tp_case(mp, q_len, int8)
    counters = (*fd.TP_COUNTERS.values(), fd.TP_PHASED_COUNTER)
    before = [c.count for c in counters]
    plain = fd.PLAIN_CALLS.count
    outs = []
    for fn in (fd.fused_step_tp_phased, fd.fused_step_tp, None):
        c = [KVCache(*(t.clone() for t in cache if t is not None)) for cache in caches]
        if fn is None:
            ys, out = fd._step_plain_tp(name, trees, [x] * mp, H // mp, c, index, tl, cl, ttm,
                                        pm, chunk)
        else:
            ys, out = fn(name, mesh, trees, c, x, H // mp, index, tl, cl, ttm, pm,
                         chunk_override=chunk)
        assert out is c and all(torch.equal(ys[0], y) for y in ys[1:])
        outs.append((ys, c))
    assert [c.count for c in counters] == before
    assert fd.PLAIN_CALLS.count == plain + 3
    (ys0, c0), *rest = outs
    for ys, c in rest:
        assert all(torch.equal(a, b) for a, b in zip(ys, ys0))
        for a, b in zip(c, c0):
            assert all(torch.equal(u, v) for u, v in zip(a, b) if u is not None)
    assert torch.isfinite(ys0[0]).all() and ys0[0].shape == x.shape


def test_tp_steps_on_cpu_refuse_a_mismatched_mesh():
    mesh, trees, caches, x, index, (tl, cl), ttm, pm = tp_case(2, 1, False)
    for fn in (fd.fused_step_tp, fd.fused_step_tp_phased):
        with pytest.raises(ValueError, match='mesh has 2 ranks'):
            fn('fused_decode_step_tp', mesh, trees[:1], caches, x, 2, index, tl, cl, ttm, pm)


def test_tp_int4_phased_twin_on_cpu_is_the_plain_step():
    """int4 W4A16 in the ranked packing: the twin's CPU route is the plain
    TP step's bits."""
    gen = torch.Generator().manual_seed(3)
    p = tq.quantize_transformer(transformer_init(gen, L, D, H, DFF, adaptive_norm=False),
                                bits=4, tp_mp=2)
    trees = shard_decode_params(tp_permute_qkv(p, 2), 2)
    _, _, caches, x, index, (tl, cl), ttm, pm = tp_case(2, 1, False)
    mesh = make_model_mesh(2, ['cpu'] * 2)
    c1 = [KVCache(c.k.clone(), c.v.clone()) for c in caches]
    c2 = [KVCache(c.k.clone(), c.v.clone()) for c in caches]
    ys, _ = fd.fused_step_tp_phased('fused_decode_step_tp', mesh, trees, c1, x, 2, index, tl,
                                    cl, ttm, pm)
    ys_p, _ = fd._step_plain_tp('fused_decode_step_tp', trees, [x] * 2, 2, c2, index, tl, cl,
                                ttm, pm, None)
    assert all(torch.equal(a, b) for a, b in zip(ys, ys_p))


def test_tp_step_builds_are_dense_and_int4():
    """The persistent TP step has its own build per weight format it takes
    (csrc/fused_step.cu with VALLE2_STEP_TP, compiled beside the one-card
    steps' builds); W8A8 has none and is refused before any build loads."""
    from valle2_tpu_torch.kernels import _build
    for layout, fmt, wf in (('w', 'dense', 0), ('q4', 'w4a16', 2)):
        name = fd._tp_build(layout)
        assert name == f'fused_step_tp_{fmt}'
        assert _build.BUILDS[name] == ('fused_step', ('--fmad=false', f'-DVALLE2_STEP_WF={wf}',
                                                      '-DVALLE2_STEP_TP=1'))
    assert 'fused_step_tp_w8a8' not in _build.BUILDS
    with pytest.raises(ValueError, match='W8A8'):
        fd._tp_build('q')
    src = STEP_CU.read_text()
    tp_part = src[src.index('#else\n// ---- The persistent TP step ----'):]
    assert 'step_tp_persistent_kernel' in src and 'valle2_fused_step_tp(' in tp_part


def test_no_serving_module_calls_a_phased_twin():
    """The phased twins are the references of tests and ``chip_smoke.py``:
    no module under ``models/``, ``parallel/``, nor ``tts.py`` or
    ``stream_hub.py`` refers to them in code (a name, an attribute or an
    import; prose may name them)."""
    import ast
    files = [*sorted((PKG / 'models').glob('*.py')), *sorted((PKG / 'parallel').glob('*.py')),
             PKG / 'tts.py', PKG / 'stream_hub.py']
    assert len(files) > 5
    twins = {'fused_step_tp_phased', 'fused_verify_step_phased'}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ({node.id} if isinstance(node, ast.Name) else
                     {node.attr} if isinstance(node, ast.Attribute) else
                     {a.name for a in node.names} if isinstance(node, ast.ImportFrom) else set())
            assert not names & twins, f'{f.name}:{node.lineno} refers to {names & twins}'
