"""One process of a two-process group for ``tests/test_torch_distributed.py``.

Run as ``python tests/torch_dist_worker.py <proc_id> <n_procs> <port> <outdir>
[gloo|nccl]``.  The worker joins a ``torch.distributed`` group through
``valle2_tpu_torch.parallel.init_distributed``'s ``$VALLE2_*`` resolution and holds
its share of a data=4 mesh: with gloo (the default) virtual CPU ranks, with NCCL its
block of the host's cards (``parallel.mesh.process_cards``).  It runs the real
``Trainer.fit`` for three steps on a deterministic synthetic stream (the data-axis
grad sums, the ZeRO-1 gathers and the checkpoint's gathers cross the processes), and
writes its final params to ``<outdir>/<tag>.npz``.  ``run_fit`` is import-safe: the
test calls it in-process over four ranks for the one-process run of the same mesh.
"""

import sys
from pathlib import Path


def run_fit(outdir: Path, tag: str, ckpt_name: str, devices) -> None:
    """Three steps of ``Trainer.fit`` on a data=4 mesh of this process's
    ``devices`` (None: its share of the cards); dumps the whole params and
    the step."""
    import numpy as np
    import torch

    from valle2_tpu_torch import train as ttrain
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import DataLoader, SyntheticValleDataset, get_collate
    from valle2_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    cfg = ConfigValle(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2,
                      batch_size=8, max_steps=3, log_every_n_steps=0, dropout=0.1,
                      bucket_sizes=(64,), norm='LayerNorm', async_checkpoint=False,
                      prefetch_batches=0, zero1=True, matmul_precision='highest')
    cfg.ckpt_path = Path(outdir) / ckpt_name
    cfg.log_path = Path(outdir) / f'logs_{tag}'
    mesh = make_mesh(data=4, model=1, devices=devices)
    state = ttrain.init_state(cfg, 'ValleAR', device=mesh.devices[0])
    collate = get_collate('ValleAR')(cfg)
    ds = SyntheticValleDataset(cfg, size=16, min_frames=30, max_frames=60)
    loader = DataLoader(ds, cfg.batch_size, collate, shuffle=False)
    trainer = ttrain.Trainer(cfg, 'ValleAR', mesh=mesh, use_tensorboard=False)
    state = trainer.fit(state, loader)
    leaves = ttrain.tree_leaves(ttrain.gather_state(state))
    np.savez(Path(outdir) / f'{tag}.npz', **{f'p{i}': leaf.numpy() for i, leaf in
                                             enumerate(leaves)},
             step=np.asarray(state.step))


def main() -> None:
    import os
    proc_id, n_procs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                      Path(sys.argv[4]))
    backend = sys.argv[5] if len(sys.argv) > 5 else 'gloo'
    os.environ['VALLE2_COORDINATOR'] = f'127.0.0.1:{port}'
    os.environ['VALLE2_NUM_PROCS'] = str(n_procs)
    os.environ['VALLE2_PROC_ID'] = str(proc_id)
    from valle2_tpu_torch.parallel import init_distributed, is_primary
    assert init_distributed(backend=backend) == n_procs, 'the group did not form'
    assert is_primary() == (proc_id == 0)
    run_fit(outdir, f'proc{proc_id}', 'ckpt_mp',
            ['cpu'] * (4 // n_procs) if backend == 'gloo' else None)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
