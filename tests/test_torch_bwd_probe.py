"""The f32 flash backward's ablation probe (``valle2_tpu_torch.probes.
bwd_ablate``) on the CPU: every variant finds its anchors in
``csrc/flash_attention_bwd.cu`` (a source edit that moves one fails here,
not on the card), a missing anchor is refused, the probe's shapes and
ragged meta are chip_smoke.py's, and without a card it refuses to run."""

import importlib.util
from pathlib import Path

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch.kernels import _build
from valle2_tpu_torch.probes import bwd_ablate

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', bwd_ablate.VARIANTS)
def test_bwd_ablate_variant_edits_the_source(name):
    src = (_build.CSRC_DIR / 'flash_attention_bwd.cu').read_text()
    out = bwd_ablate.variant(src, name)
    assert (out == src) == (name == 'kernel')


def test_bwd_ablate_refuses_a_missing_anchor():
    with pytest.raises(RuntimeError, match='anchor'):
        bwd_ablate.variant('// no kernel here\n', 'no_mask')


def test_bwd_ablate_shapes_are_chip_smokes():
    cs = chip_smoke()
    assert bwd_ablate.SHAPES == cs.TRAIN_CASES
    assert (bwd_ablate.H, bwd_ablate.HD) == (cs.SLICE['h'], cs.SLICE['hd'])
    for b, tt, frames, _ in bwd_ablate.SHAPES.values():
        assert torch.equal(bwd_ablate.train_meta(b, tt, frames, 'cpu'),
                           cs.train_meta(b, tt, frames, 'cpu'))


def test_bwd_ablate_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the probe would run')
    with pytest.raises(RuntimeError, match='CUDA card'):
        bwd_ablate.run()
