"""The f32 flash forward's ablation probe (``valle2_tpu_torch.probes.
fwd_ablate``) on the CPU: every variant finds its anchors in
``csrc/flash_attention.cu`` with ``cc_tiles.cuh`` inlined (a source edit
that moves one fails here, not on the card), a missing anchor is refused,
the probe's shapes and ragged meta are chip_smoke.py's, and without a card it
refuses to run.  Also the wrappers' 16-byte alignment check, which the CUDA
kernels need and which runs before any launch."""

import importlib.util
from pathlib import Path

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch.kernels import _build
from valle2_tpu_torch.kernels import flash_attention as fa
from valle2_tpu_torch.probes import bwd_ablate, fwd_ablate

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', fwd_ablate.VARIANTS)
def test_fwd_ablate_variant_edits_the_source(name):
    src = (_build.CSRC_DIR / 'flash_attention.cu').read_text()
    out = fwd_ablate.variant(src, name)
    assert (out == src) == (name == 'kernel')
    if name != 'kernel':
        assert '#include "cc_tiles.cuh"' not in out and 'rows_dot' in out


def test_fwd_ablate_refuses_a_missing_anchor():
    with pytest.raises(RuntimeError, match='anchor'):
        fwd_ablate.variant('// no kernel here\n', 'no_pv')


def test_fwd_ablate_shapes_are_chip_smokes():
    cs = chip_smoke()
    assert fwd_ablate.SHAPES == cs.TRAIN_CASES
    assert (fwd_ablate.H, fwd_ablate.HD) == (cs.SLICE['h'], cs.SLICE['hd'])
    for b, tt, frames, _ in fwd_ablate.SHAPES.values():
        assert torch.equal(fwd_ablate.train_meta(b, tt, frames, 'cpu'),
                           cs.train_meta(b, tt, frames, 'cpu'))


def test_fwd_ablate_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the probe would run')
    with pytest.raises(RuntimeError, match='CUDA card'):
        fwd_ablate.run()


def test_inlined_header_keeps_one_copy_of_the_products():
    """Both probes inline the shared micro-tile header in place of its
    include: the products they edit appear once, and neither the include nor
    the header's include guard is left."""
    for stem in ('flash_attention', 'flash_attention_bwd'):
        src = (_build.CSRC_DIR / f'{stem}.cu').read_text()
        assert src.count('#include "cc_tiles.cuh"') == 1
        out = bwd_ablate.inline_header(src)
        assert out.count('void rows_dot(') == 1 and out.count('void rows_times(') == 1
        assert '#pragma once' not in out


@pytest.mark.parametrize('which', ['q', 'k', 'v'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_forward_alignment_check_refuses_a_shifted_view(which, dtype):
    """``_check_aligned`` (run by #1's and #2's wrappers before a launch)
    refuses q, k or v that does not start on a 16-byte boundary, and passes
    tensors that do."""
    flat = torch.zeros(2 * 16 * 32 + 8, dtype=dtype)
    aligned = flat[:2 * 16 * 32].view(1, 2, 16, 32)
    shifted = flat[1:2 * 16 * 32 + 1].view(1, 2, 16, 32)
    if aligned.data_ptr() % 16:
        pytest.skip('the allocator gave an unaligned base')
    fa._check_aligned('flash_attention', aligned, aligned, aligned)
    args = {n: (shifted if n == which else aligned) for n in 'qkv'}
    with pytest.raises(ValueError, match='16-byte aligned'):
        fa._check_aligned('flash_attention', args['q'], args['k'], args['v'])
