"""Multi-process runtime initialization (``valle2_tpu/parallel/distributed.py``).

Each process of a run holds its own devices, and ``torch.distributed``
connects the processes: gloo for CPU tensors, NCCL for cards.  Everything
downstream is topology-agnostic: a mesh built after ``init_distributed``
(``parallel.make_mesh``) holds this process's ranks, placement cuts each
process's blocks from the whole value that every process holds (the data
path feeds every process the same batch stream, and params init alike from
the seed), and the data-axis sums gather every rank's tensor and add them
in rank order (``Mesh.gather_data``).  So a run over several processes
computes bit for bit the update of one process driving the same mesh
(``tests/test_torch_distributed.py``).  NCCL takes one process per card:
the processes of one host share its cards in blocks
(``mesh.process_cards``), and too few cards raise.

Resolution: explicit args, then ``$VALLE2_COORDINATOR`` (``host:port``) /
``$VALLE2_NUM_PROCS`` / ``$VALLE2_PROC_ID``; with neither, a one-process
run and nothing to do.
"""

from __future__ import annotations

import logging
import os

import torch

__all__ = ['init_distributed', 'is_primary']

log = logging.getLogger('valle2_tpu_torch.parallel')


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None) -> int:
    """Join this process to a ``torch.distributed`` group; returns the
    number of processes.  A no-op returning the group's size when it is
    already up, and 1 when no coordinator is configured.  ``backend``:
    'nccl' where a card is available, else 'gloo'."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    coordinator = coordinator or os.environ.get('VALLE2_COORDINATOR')
    if num_processes is None and os.environ.get('VALLE2_NUM_PROCS'):
        num_processes = int(os.environ['VALLE2_NUM_PROCS'])
    if process_id is None and os.environ.get('VALLE2_PROC_ID'):
        process_id = int(os.environ['VALLE2_PROC_ID'])
    if coordinator is None and num_processes is None:
        return 1
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError('a multi-process run needs the coordinator (host:port), the '
                         'number of processes and this process\'s id')
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        # One host: process p's cards are the block make_mesh gives it
        # (mesh.process_cards); NCCL refuses two processes on one card.
        per = torch.cuda.device_count() // num_processes
        if per < 1:
            raise ValueError(f'{num_processes} processes on {torch.cuda.device_count()} '
                             'cards: NCCL takes one process per card')
        torch.cuda.set_device(process_id * per)
    address = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    log.info('Distributed runtime: process %d/%d (%s)', process_id, num_processes, backend)
    return num_processes


def is_primary() -> bool:
    """True on process 0, which owns the singleton side effects (metrics
    writers, logs, checkpoint files); the steps and the gathers they need
    run on every process."""
    import torch.distributed as dist
    return not (dist.is_initialized() and dist.get_rank() != 0)
