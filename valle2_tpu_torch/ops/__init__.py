"""NN primitives: plain functions over dict parameters (PyTorch)."""

from .attention import mha, mha_init, qkv_proj, sdpa
from .masks import NEG_INF, build_pad_mask, mask_to_bias, prefix_lm_attend, prefix_lm_bias
from .nn import (adaln, adaln_init, add_positional, cast_to_compute, dropout, embedding,
                 embedding_init, ffn, ffn_init, layernorm, layernorm_init, linear,
                 linear_init, sinusoidal_table)
from .sampling import best_beam_index, categorical, top_k_top_p_filter, topk_sampling
from .transformer import (KVCache, encoder_layer, transformer, transformer_decode_step,
                          transformer_init, transformer_prefill)

__all__ = [
    'mha', 'mha_init', 'qkv_proj', 'sdpa', 'NEG_INF', 'build_pad_mask', 'mask_to_bias',
    'prefix_lm_attend', 'prefix_lm_bias', 'adaln', 'adaln_init', 'add_positional',
    'cast_to_compute', 'dropout', 'embedding', 'embedding_init', 'ffn', 'ffn_init',
    'layernorm', 'layernorm_init', 'linear', 'linear_init', 'sinusoidal_table',
    'best_beam_index', 'categorical', 'top_k_top_p_filter', 'topk_sampling', 'KVCache',
    'encoder_layer', 'transformer', 'transformer_decode_step', 'transformer_init',
    'transformer_prefill',
]
