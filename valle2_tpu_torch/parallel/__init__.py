"""Tensor-parallel serving over a ('model',) mesh (``valle2_tpu/parallel``)."""

from .mesh import (Mesh, make_mesh, make_model_mesh, on_device, shard_decode_params,
                   shard_stack, tp_divisible, tp_permute_qkv, training_mesh)

__all__ = ['Mesh', 'make_mesh', 'make_model_mesh', 'on_device', 'shard_decode_params',
           'shard_stack', 'tp_divisible', 'tp_permute_qkv', 'training_mesh']
