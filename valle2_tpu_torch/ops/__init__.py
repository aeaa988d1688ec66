"""NN primitives: plain functions over dict parameters (PyTorch)."""

from .attention import mha, mha_init, qkv_proj, sdpa
from .masks import NEG_INF, build_pad_mask, mask_to_bias, prefix_lm_attend, prefix_lm_bias
from .nn import (adaln, adaln_init, add_positional, cast_to_compute, decode_logits, dropout,
                 embedding, embedding_init, ffn, ffn_init, layernorm, layernorm_init, linear,
                 linear_init, sinusoidal_table)
from .sampling import (best_beam_index, categorical, categorical_rows, top_k_top_p_filter,
                       topk_sampling, topk_sampling_rows)
from .transformer import (KVCache, encoder_layer, transformer, transformer_decode_step,
                          transformer_init, transformer_prefill)

__all__ = [
    'mha', 'mha_init', 'qkv_proj', 'sdpa', 'NEG_INF', 'build_pad_mask', 'mask_to_bias',
    'prefix_lm_attend', 'prefix_lm_bias', 'adaln', 'adaln_init', 'add_positional',
    'cast_to_compute', 'dropout', 'embedding', 'embedding_init', 'ffn', 'ffn_init',
    'layernorm', 'layernorm_init', 'linear', 'linear_init', 'sinusoidal_table',
    'decode_logits',
    'best_beam_index', 'categorical', 'categorical_rows', 'top_k_top_p_filter',
    'topk_sampling', 'topk_sampling_rows', 'KVCache',
    'encoder_layer', 'transformer', 'transformer_decode_step', 'transformer_init',
    'transformer_prefill',
]
