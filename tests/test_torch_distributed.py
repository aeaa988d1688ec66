"""The port's multi-process runtime (``valle2_tpu_torch.parallel.distributed``).

``init_distributed`` with no cluster is a no-op returning 1.  The two-process test
runs ``tests/torch_dist_worker.py`` twice, a gloo group of two CPU processes with two
virtual ranks each, training three steps of ``Trainer.fit`` on a data=4 mesh (dropout
and ZeRO-1 on: the rows' masks, the data-axis grad sums and the ZeRO-1 gathers cross
the processes), and holds the final params bit for bit equal across the two processes
and to the same fit in one process over four virtual ranks: the sums over ranks run in
rank order whatever the processes.  The card test (marker ``cuda``) runs the same fit
over NCCL, two processes of two cards each on a four-card host, against one process
over the four cards; run it there as
``python -m pytest --noconftest -m cuda tests/test_torch_distributed.py -q``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_init_distributed_is_a_noop_without_a_cluster(monkeypatch):
    from valle2_tpu_torch.parallel import init_distributed, is_primary
    from valle2_tpu_torch.parallel.mesh import process_info
    for var in ('VALLE2_COORDINATOR', 'VALLE2_NUM_PROCS', 'VALLE2_PROC_ID'):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == 1
    assert is_primary() and process_info() == (1, 0)
    monkeypatch.setenv('VALLE2_NUM_PROCS', '2')
    with pytest.raises(ValueError, match='coordinator'):
        init_distributed()


def _run_workers(tmp_path, backend: str) -> None:
    """The two worker processes of ``torch_dist_worker.py``, to their end."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith('VALLE2_')}
    procs = [subprocess.Popen([sys.executable, str(REPO / 'tests' / 'torch_dist_worker.py'),
                               str(i), '2', str(port), str(tmp_path), backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=dict(env, PYTHONPATH=str(REPO)))
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {i} failed:\n{out}'


def _check_bit_identical(tmp_path) -> None:
    solo, p0, p1 = (np.load(tmp_path / f'{t}.npz') for t in ('solo', 'proc0', 'proc1'))
    assert set(p0.files) == set(p1.files) == set(solo.files)
    assert int(p0['step']) == int(solo['step']) == 3
    for k in solo.files:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=f'proc0[{k}] != proc1[{k}]')
        np.testing.assert_array_equal(p0[k], solo[k], err_msg=f'proc0[{k}] != one process')
    # The primary alone wrote the checkpoint (whole tensors gathered by both).
    assert list((tmp_path / 'ckpt_mp' / 'ValleAR').glob('step_3'))


def _run_fit():
    sys.path.insert(0, str(REPO / 'tests'))
    from torch_dist_worker import run_fit
    return run_fit


def test_two_process_fit_is_bit_identical_to_one_process(tmp_path):
    _run_workers(tmp_path, 'gloo')
    _run_fit()(tmp_path, 'solo', 'ckpt_solo', ['cpu'] * 4)
    _check_bit_identical(tmp_path)


@pytest.mark.cuda
def test_two_process_nccl_fit_on_four_cards_is_bit_identical(tmp_path):
    """The fit over NCCL: two processes, each holding its block of two cards
    (``process_cards``), == one process over the four cards, bit for bit
    (the head dim 16 takes the plain attention: no atomics on the path)."""
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip('needs a host of four CUDA cards: NCCL takes one process per card')
    _run_workers(tmp_path, 'nccl')
    _run_fit()(tmp_path, 'solo', 'ckpt_solo', [f'cuda:{k}' for k in range(4)])
    _check_bit_identical(tmp_path)
