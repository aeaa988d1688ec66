#!/usr/bin/env python3
"""Convert a JAX package checkpoint (orbax) into the PyTorch port's layout.

    python scripts/orbax_to_torch.py SRC OUT -c cfg.json -m ValleAR

SRC is either

- a params checkpoint (``valle2_tpu.models.ar.ValleAR.save`` /
  ``models.checkpoint.save_params``): OUT becomes one params file, the layout
  of ``valle2_tpu_torch.models.checkpoint.save_params`` (``ValleAR(...).load``
  and the CLIs' ``--ar-ckpt`` / ``--nar-ckpt`` read it); or
- a trainer step dir (``valle2_tpu.train.Trainer.save_checkpoint``:
  ``{'params', 'opt_state', 'step'}``, a LoRA fine-tune's params
  ``{'base', 'lora'}`` included): OUT becomes a step dir holding
  ``state.pt``, the layout of ``valle2_tpu_torch.train.Trainer``, so the run
  resumes in the port (copy it to ``<ckpt_path>/<model>/step_N`` and pass
  ``--resume``).  optax AdamW's ``mu``, ``nu`` and ``count`` become the port
  optimizer's ``exp_avg``, ``exp_avg_sq`` and step count.

``-c`` and ``-m`` give the model the checkpoint was written for: its tree is
restored against the JAX package's own init of that config, and each leaf
lands at the same key of the port's init.  A run with ``grad_accum`` > 1
(``optax.MultiSteps``) is refused.

This is the one file outside the tests that imports both packages: orbax
imports JAX, so the port cannot read orbax itself.  Run it where JAX and
orbax are installed; the port's machine needs neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _restore(path: Path, item=None):
    import orbax.checkpoint as ocp
    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(path.resolve(), item=item) if item is not None \
            else ckptr.restore(path.resolve())


def _onto(template, tree, where: str = ''):
    """``tree`` (numpy / JAX leaves) laid onto the port's ``template``: same
    keys, the template's key order, dtypes and CPU tensors."""
    import torch
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            found = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f'checkpoint structure differs from the port model at '
                             f'{where or "/"}: {found}')
        return {k: _onto(template[k], tree[k], f'{where}/{k}') for k in template}
    a = np.asarray(tree, np.float32)
    if tuple(a.shape) != tuple(template.shape):
        raise ValueError(f'{where}: checkpoint shape {a.shape} != port shape '
                         f'{tuple(template.shape)}')
    return torch.from_numpy(a.copy()).to(template.dtype)


def _adam_states(state) -> list:
    """The ``optax.ScaleByAdamState``s inside an optimizer state."""
    import optax
    if isinstance(state, optax.ScaleByAdamState):
        return [state]
    if isinstance(state, (tuple, list)):
        return [s for x in state for s in _adam_states(x)]
    return []


def convert(src, out, config, model: str) -> str:
    """Convert ``src`` (a JAX params checkpoint or trainer step dir) into
    ``out``; returns 'params' or 'trainer', the layout found."""
    import jax
    import torch

    from valle2_tpu import train as jtrain
    from valle2_tpu.config import ConfigValle as JConfig
    from valle2_tpu_torch import train as ttrain
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models.checkpoint import STATE_FILE, atomic_save, save_params, to_cpu

    src, out = Path(src), Path(out)
    raw = _restore(src)
    cfg = ConfigValle(**{**dataclasses.asdict(config), 'lora_base': ''})
    jcfg = JConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JConfig)
                      if hasattr(cfg, f.name)})
    port = ttrain.init_state(cfg, model, device='cpu')
    if not (isinstance(raw, dict) and {'params', 'opt_state', 'step'} <= set(raw)):
        template = port.params['base'] if cfg.lora_rank > 0 else port.params
        jtemplate = jtrain.INIT_FNS[model](jax.random.key(0), jcfg)
        params = _onto(template, _restore(src, jtemplate))
        save_params(out, params)
        return 'params'
    if cfg.grad_accum > 1:
        raise ValueError('grad_accum > 1: the JAX optimizer state is an optax.MultiSteps '
                         'state (its own accumulator and inner state), which this script '
                         'does not convert; convert a run trained with grad_accum 1')
    jstate = jtrain.init_state(jcfg, model, jax.random.key(0))
    item = _restore(src, {'params': jstate.params, 'opt_state': jstate.opt_state,
                          'step': jstate.step})
    params = _onto(port.params, item['params'])
    trained = params['lora'] if cfg.lora_rank > 0 else params
    adam = _adam_states(item['opt_state'])
    if len(adam) != 1:
        raise ValueError(f'expected one AdamW state in the optimizer state, found {len(adam)}')
    count, mu, nu = int(np.asarray(adam[0].count)), adam[0].mu, adam[0].nu
    mu, nu = _onto(trained, mu), _onto(trained, nu)
    with torch.no_grad():
        for p, x in zip(ttrain.tree_leaves(port.params), ttrain.tree_leaves(params)):
            p.copy_(x)
    opt = port.opt_state
    for p, m, v in zip(opt.leaves, ttrain.tree_leaves(mu), ttrain.tree_leaves(nu)):
        opt.adamw.state[p] = {'step': torch.tensor(float(count)), 'exp_avg': m.clone(),
                              'exp_avg_sq': v.clone()}
    opt.count = count
    out.mkdir(parents=True, exist_ok=True)
    atomic_save({'params': to_cpu(port.params), 'opt_state': to_cpu(opt.state_dict()),
                 'step': int(np.asarray(item['step']))}, out / STATE_FILE)
    return 'trainer'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='JAX (orbax) checkpoint → PyTorch port')
    parser.add_argument('src', type=Path, help='orbax params checkpoint or trainer step dir')
    parser.add_argument('out', type=Path, help='port params file, or step dir for a trainer '
                                               'checkpoint')
    parser.add_argument('-c', '--config', type=Path, required=True)
    parser.add_argument('-m', '--model', choices=['ValleAR', 'ValleNAR', 'ValleASR'],
                        required=True)
    args = parser.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from valle2_tpu_torch.config import ConfigValle
    kind = convert(args.src, args.out, ConfigValle.from_json(args.config), args.model)
    print(f'{args.src} ({kind}) -> {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
