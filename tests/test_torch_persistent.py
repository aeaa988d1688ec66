"""The host-side plan of the persistent fused decode step (#6 as one
cooperative launch a step): ``kernels.fused_decode.persistent_plan`` and its
parts, which say what one launch does and how much shared memory a block
takes.  The launcher (csrc/fused_step.cu ``step_persistent``) sizes itself
the same way; on the card tests/test_torch_cuda.py holds the two equal
(``step_grid``) and the step bit for bit against the phased route.  Here:
the plan's counts at the serving and 204M widths; the projection tile's
switch to 8 rows; the shared memory of every stack the kernels take fits a
block; the plan's constants are the kernel source's."""

import re
from pathlib import Path

import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch.kernels import fused_decode as fd

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
    """The tile constants the plan mirrors, read from csrc/fused_decode.cuh."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    assert const('NCOL') == fd._NCOL and const('KSPLIT') == fd._KSPLIT
    assert const('ANW') == fd._ANW
    assert re.search(r'constexpr int PNT = NCOL \* KSPLIT;', src)
    assert fd._NCOL * fd._KSPLIT == fd.PERSISTENT_THREADS
    k16 = re.search(r'max_k16\(int wf\) \{ return wf == W8 \? (\d+) : (\d+); \}', src)
    assert (int(k16.group(1)), int(k16.group(2))) == (fd._MAX_K16[1], fd._MAX_K16[0])
    assert fd._MAX_K16[2] == fd._MAX_K16[0]
