"""Meshes, the sharding rules and the multi-process runtime (``valle2_tpu/parallel``):
data-parallel and tensor-parallel training and serving over a ('data', 'model') mesh,
and pipeline-parallel training over a ('data', 'pipe'[, 'model']) mesh."""

from .distributed import init_distributed, is_primary
from .mesh import (Mesh, PerReplica, Sharded, data_rows, data_shard_map, device_put_global,
                   gather_params, make_mesh, make_model_mesh, on_device, param_sharding,
                   placement, sequence_parallel_spec, shard_batch,
                   shard_decode_params, shard_params, shard_stack, tp_decode_specs,
                   tp_divisible, tp_permute_qkv, tp_shard_map, tp_unpermute_qkv, training_mesh)
from .pipeline import (make_pp_eval_step, make_pp_mesh, make_pp_train_step,
                       pipeline_transformer, pp_opt_specs, pp_param_specs, pp_shard_params)
from .pipeline_1f1b import make_pp_train_step_1f1b

__all__ = ['Mesh', 'PerReplica', 'Sharded', 'data_rows', 'data_shard_map',
           'device_put_global', 'gather_params', 'init_distributed', 'is_primary',
           'make_mesh', 'make_model_mesh', 'make_pp_eval_step', 'make_pp_mesh',
           'make_pp_train_step', 'make_pp_train_step_1f1b', 'on_device', 'param_sharding',
           'pipeline_transformer', 'placement', 'pp_opt_specs', 'pp_param_specs',
           'pp_shard_params', 'sequence_parallel_spec', 'shard_batch', 'shard_decode_params',
           'shard_params', 'shard_stack', 'tp_decode_specs', 'tp_divisible', 'tp_permute_qkv',
           'tp_shard_map', 'tp_unpermute_qkv', 'training_mesh']
