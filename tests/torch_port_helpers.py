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


def make_requests(n, seed=0):
    """n serving requests as the JAX package's server tests build them:
    (text, prompt tokens, prompt codes (frames, 8))."""
    rs = np.random.RandomState(seed)
    return [(f'request number {i}.', rs.randint(0, 70, (3 + i % 4,)),
             rs.randint(0, 1024, (4 + i % 3, 8))) for i in range(n)]


def serving_weights(cfg_kw: dict):
    """((JAX AR, NAR, codec params), (their port copies)) of one seeded JAX
    init, carried by the state-dict converters; the codec's decoder and
    quantizer only."""
    import jax

    from valle2_tpu.codec import encodec as jenc
    from valle2_tpu.config import ConfigValle as JConfig
    from valle2_tpu.models import ar as jar
    from valle2_tpu.models import nar as jnar
    from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
    from valle2_tpu_torch.models.convert import (codec_params_from_numpy, load_ar_state_dict,
                                                 load_nar_state_dict)
    jcfg = JConfig(**cfg_kw)
    jp_ar = jar.init_params(jax.random.key(0), jcfg)
    jp_nar = jnar.init_params(jax.random.key(1), jcfg)
    codec = jenc.init_params(jax.random.key(3))
    tp = (load_ar_state_dict(export_ar_state_dict(jp_ar)),
          load_nar_state_dict(export_nar_state_dict(jp_nar)),
          codec_params_from_numpy(to_np({'decoder': codec['decoder'], 'rvq': codec['rvq']})))
    return (jp_ar, jp_nar, codec), tp


def serving_tts(weights, cfg_kw: dict, mesh=None):
    """A port ``ValleTTS`` on the CPU over ``serving_weights``' port copies."""
    from valle2_tpu_torch.codec import Encodec
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR, ValleNAR
    from valle2_tpu_torch.tts import ValleTTS
    cfg = ConfigValle(**cfg_kw)
    ar_p, nar_p, codec_p = weights[1]
    return ValleTTS(cfg, ar=ValleAR(cfg, params=ar_p, device='cpu', mesh=mesh),
                    nar=ValleNAR(cfg, params=nar_p, device='cpu'),
                    codec=Encodec(params=codec_p, device='cpu'), device='cpu', mesh=mesh)
