"""Card tests of the mesh path: the flash kernels per (data, model) shard and 5c under
autograd against their plain versions, and mesh train steps against the solo step, on
virtual ranks of one card (``['cuda:0'] * n``).

Marked ``cuda``: every test skips where there is no CUDA card.  Run on the card as
``python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py -q``.
Tolerances: f32 with TF32 off; the kernels against their plain versions within 1e-4
(the plain versions' f32 sums in another order), 5c bit for bit with its plain version
(the rank-ordered sum, the same epilogue), per-shard flash bit for bit with the
kernels on the whole tensors (each (row, head) is the same work) but for #3's dq
(atomics), a mesh step's grads within 1e-5 of the leaf's largest against the solo
step's.
"""

import pytest
import torch

from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle, precision_scope
from valle2_tpu_torch.kernels import flash_attention as fa
from valle2_tpu_torch.kernels import tp_allreduce as ta
from valle2_tpu_torch.ops import nn as tnn
from valle2_tpu_torch.parallel import data_rows, make_mesh

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=0.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels build with nvcc and run only there')
    with precision_scope(ConfigValle(matmul_precision='highest')):
        yield torch.device('cuda')


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('s', [320, 1024], ids=['fused_bwd', 'split_bwd'])
def test_flash_per_shard_equals_whole_and_plain(dev, s, causal):
    """The kernels per (data, model) shard of a 2 x 2 mesh of one card's
    virtual ranks, as mha_tp runs them (a data rank's rows, a model rank's
    heads, made contiguous): forward (#1) and backward (#3, or #4 + #5 past
    s = 768) put back together == the kernels on the whole tensors (the
    forward and #4 + #5 bit for bit; #3 sums dq through atomics, in an order
    that changes from run to run, so within 1e-4), and == the plain versions
    within 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hd, tt = 4, 4, 64, 64
    q, k, v = (torch.randn(b, h, s, hd, generator=gen, device=dev).requires_grad_()
               for _ in range(3))
    meta = torch.tensor([[tt, s], [tt - 5, s - 40], [tt, s - 7], [3, s]], dtype=torch.int32,
                        device=dev)
    do = torch.randn(b, h, s, hd, generator=gen, device=dev)
    before = fa.COUNTER.count
    on = make_mesh(2, 2, ['cuda:0'] * 4)
    rows = []
    for i in on.local_data:
        cut = data_rows(on, b, i)
        heads = [fa.FlashAttention.apply(*(t[cut, j * 2:(j + 1) * 2].contiguous()
                                           for t in (q, k, v)),
                                         meta[cut].contiguous(), tt, causal)
                 for j in range(on.model)]
        rows.append(torch.cat(heads, 1))
    got = torch.cat(rows)
    gg = torch.autograd.grad(got, [q, k, v], do)
    assert fa.COUNTER.count - before == 4                  # one forward launch a shard
    want = fa.FlashAttention.apply(q, k, v, meta, tt, causal)
    wg = torch.autograd.grad(want, [q, k, v], do)
    assert torch.equal(got, want)
    for a, c in zip(gg, wg):
        if fa.uses_fused_bwd(s):
            torch.testing.assert_close(a, c, **TOL)
        else:
            assert torch.equal(a, c)
    with torch.no_grad():
        o, lse = fa.flash_attention_plain(q, k, v, meta, tt, causal)
        plain = fa.flash_attention_bwd_plain(q, k, v, meta, o, lse, do, tt, causal)
    torch.testing.assert_close(got, o, **TOL)
    for a, c in zip(gg, plain):
        torch.testing.assert_close(a, c, **TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_differentiable_5c_equals_its_plain_version(dev, dtype):
    """psum_replicated_grad on two virtual ranks: one 5c launch for the sum
    with the bias and the residual, bit-equal to tp_row_reduce_plain; its
    backward the identity (each partial its rank's cotangent)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    parts = [torch.randn(2, 320, 256, generator=gen, device=dev).requires_grad_()
             for _ in range(2)]
    bias = [torch.randn(256, generator=gen, device=dev).to(dtype).requires_grad_()
            for _ in range(2)]
    res = [torch.randn(2, 320, 256, generator=gen, device=dev).to(dtype).requires_grad_()
           for _ in range(2)]
    before = ta.COUNTER.count
    outs = tnn.psum_replicated_grad(parts, bias, res, dtype)
    assert ta.COUNTER.count - before == 1                  # one launch for both ranks
    want = ta.tp_row_reduce_plain([p.detach() for p in parts], [x.detach() for x in bias],
                                  [x.detach() for x in res], dtype)
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    cts = [torch.randn(2, 320, 256, generator=gen, device=dev).to(dtype) for _ in range(2)]
    g = torch.autograd.grad(outs, parts + bias + res, cts)
    assert torch.equal(g[0], cts[0].float()) and torch.equal(g[5], cts[1])


@pytest.mark.parametrize('args', [(2, 1), (2, 2)], ids=['data2', '2x2_sp_zero1'])
@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_mesh_step_grads_equal_solo_on_the_card(dev, model, args):
    """The loss and every leaf's grad of a mesh step on the card (flash per
    shard, 5c under autograd at 2 x 2 with sequence parallelism and ZeRO-1,
    dropout on) == the solo step's; the kernels launched."""
    cfg = ConfigValle(d_model=128, n_heads=2, dim_feedforward=256, num_layers=2,
                      dropout=0.1, matmul_precision='highest', zero1=True,
                      sequence_parallel=True)
    b, frames = 4, 160
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {'tokens': torch.randint(0, 256, (b, 40), generator=gen, device=dev),
             'tokens_lens': torch.tensor([40, 30, 40, 25], device=dev),
             'codes_lens': torch.tensor([160, 120, 150, 160], device=dev)}
    if model == 'ValleNAR':
        batch['codes'] = torch.randint(0, 1024, (b, frames, 8), generator=gen, device=dev)
    else:
        batch['codes'] = torch.randint(0, 1026, (b, frames), generator=gen, device=dev)
        batch['target'] = torch.randint(0, 1025, (b, frames), generator=gen, device=dev)
    loss_fn = ttrain.LOSS_FNS[model]
    solo = ttrain.init_state(cfg, model, device=dev)
    loss, m = loss_fn(solo.params, cfg, batch, ttrain.step_generator(0, 0, dev))
    want = torch.autograd.grad(loss, solo.opt_state.leaves)
    on = make_mesh(*args, ['cuda:0'] * (args[0] * args[1]))
    state = ttrain.shard_state(on, ttrain.init_state(cfg, model, device=dev), cfg)
    before = (fa.COUNTER.count, fa.BWD_FUSED_COUNTER.count, ta.COUNTER.count)
    mloss, mm = loss_fn(state.params, cfg, batch, ttrain.step_generator(0, 0, dev), mesh=on)
    leaves = state.opt_state.leaves
    grads = torch.autograd.grad(mloss, leaves, allow_unused=True)   # the copies on j > 0
    got = state.opt_state.whole_grads([torch.zeros_like(p) if g is None else g
                                       for p, g in zip(leaves, grads)])
    after = (fa.COUNTER.count, fa.BWD_FUSED_COUNTER.count, ta.COUNTER.count)
    assert after[0] > before[0] and after[1] > before[1]
    assert (after[2] > before[2]) == (args[1] > 1)
    torch.testing.assert_close(mm['loss'], m['loss'], atol=1e-5, rtol=1e-5)
    for g, w in zip(got, want):
        w = w.cpu()
        torch.testing.assert_close(g, w, atol=1e-5 * max(1.0, float(w.abs().max())),
                                   rtol=0)
