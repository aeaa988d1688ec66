"""The 1F1B pipeline schedule: one forward and one backward a tick, with
O(P) activation liveness (``valle2_tpu/parallel/pipeline_1f1b.py``).

The GPipe step (``pipeline.PipelineRun.gpipe``) keeps every unit's autograd
graph until its backward, so all M microbatches' stage activations are
alive when the backward starts.  1F1B (Narayanan et al. 2019, PipeDream;
Megatron-LM's default) starts a microbatch's backward as soon as the last
stage has its loss, so a stage holds O(P) microbatches whatever M is, the
knob that lets M grow to shrink the bubble (P-1)/(M+P-1) without growing
the activation memory.

The schedule runs T = M + 2P - 2 ticks.  At tick t stage s does one forward
unit, microbatch t - s, under ``torch.no_grad``, keeping only its INPUT in a
ring; the last stage runs the head, the loss and their backward in the same
tick, seeding its cotangent (the 1F1B property).  Then stage s does one
backward unit, microbatch t - (2(P-1) - s): it runs the stage forward again
from the saved input, with grad, and takes its vector-Jacobian product (the
activation-recompute 1F1B; stage 0 recomputes the embeddings from the
batch).  The last stage's backward unit is the microbatch of its own
forward unit, so it runs that forward once, with grad, and takes the VJP
in the same tick.  A microbatch's input lives at stage s < P - 1 for
2(P-1-s) + 1 ticks, so a stage holds at most min(M, 2P - 3) inputs (JAX's
ring has min(M, 2P) slots), and no autograd graph outlives its tick.
The recompute draws the forward's dropout masks again from fresh
generators of the same seeds (``pipeline.Draws``), and each stage
accumulates its microbatches' grads in microbatch order, as GPipe does: the
two schedules give the same grads.  A tick costs about a forward and a
forward plus backward, the remat'd GPipe step's cost, with O(P) memory in
place of O(M).
"""

from __future__ import annotations

import torch

from .mesh import Mesh
from .pipeline import PipelineRun, make_pp_step


def one_f_one_b(run: PipelineRun) -> None:
    """The 1F1B schedule of ``run`` (see the module docstring); afterwards
    ``run.grads()`` and ``run.metrics()`` hold the step's result and
    ``run.ring_peak`` the most inputs one stage held at once."""
    P = run.P
    for t in run.ticks(2 * P - 2):
        for k, i, _, n_mb, _ in run.ranks:
            for s in range(P):                      # forward units
                m = t - s
                if not 0 <= m < n_mb:
                    continue
                x = None if s == 0 else run.inbox.pop((k, s, m))
                if s == P - 1:
                    # the last stage's backward unit is this microbatch's:
                    # its forward keeps the graph for the one tick
                    x_leaf = None if x is None else x.requires_grad_()
                    with torch.enable_grad():
                        y = run._forward(k, i, s, m, x_leaf)
                    run.cts[(k, s, m)] = run._head(k, m, y)
                    run._back(k, i, s, m, y, x_leaf)
                    continue
                with torch.no_grad():
                    y = run._forward(k, i, s, m, x)
                if s > 0:
                    run.ring[(k, s, m)] = x
                    run.ring_peak = max(run.ring_peak,
                                        sum(1 for key in run.ring if key[:2] == (k, s)))
                run._send(k, i, s, m, y)
            for s in reversed(range(P - 1)):        # backward units
                m = t - (2 * (P - 1) - s)
                if not 0 <= m < n_mb:
                    continue
                x_leaf = None if s == 0 else run.ring.pop((k, s, m)).requires_grad_()
                with torch.enable_grad():
                    y = run._forward(k, i, s, m, x_leaf)
                run._back(k, i, s, m, y, x_leaf)


def make_pp_train_step_1f1b(config, model_name: str, mesh: Mesh,
                            microbatches: int | None = None):
    """The 1F1B train step (JAX ``make_pp_train_step_1f1b``), a drop-in for
    ``pipeline.make_pp_train_step``: the same state, batch and metrics, the
    same compositions (data, model, ZeRO-1, LoRA, ``grad_accum``)."""
    return make_pp_step(config, model_name, mesh, one_f_one_b, '1f1b', microbatches)
