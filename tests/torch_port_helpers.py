"""Shared helpers of the tests that hold ``valle2_tpu_torch`` against ``valle2_tpu``:
pytrees cross between the packages as numpy arrays."""

import numpy as np
import pytest
import torch

@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch's CPU ops run one thread while a port test module runs (each
    imports this autouse fixture).  The suite runs in several pytest workers
    on one machine; at these widths torch's intra-op threads gain nothing,
    and a pool of one thread per core in every worker oversubscribes the
    cores many times over: under six workers the port's files took about
    eight times their serial time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2, dropout=0.0,
             kv_cache_dtype='float32', matmul_precision='highest')


def to_torch(tree, dtype=None):
    """JAX/numpy pytree (dicts and lists) → the same structure of torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def to_np(tree):
    """JAX pytree → numpy leaves."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    return np.asarray(tree)


def close(got, want, atol=1e-5, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)
