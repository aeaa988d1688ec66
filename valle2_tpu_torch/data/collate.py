"""Static-shape bucketed collate (a copy of ``valle2_tpu/data/collate.py``,
numpy only).

Same keys and per-item transforms as the reference collate (AR: first
codebook, BOS-prefixed input, EOS-appended target; NAR: full (T, nq) codes;
ASR: the AR layout with the streams swapped), with sequences padded to a
bucket width from ``config.bucket_sizes``.  Outputs are numpy; the trainer
moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import ConfigValle


def get_collate(model_name: str):
    collate_dict = {
        'ValleAR': ValleARCollate,
        'ValleNAR': ValleNARCollate,
        'ValleASR': ValleASRCollate,
    }
    return collate_dict[model_name]


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (last bucket if none fits — callers should filter)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to(arrs: list[np.ndarray], width: int, value: int = 0) -> np.ndarray:
    """Stack 1D/2D arrays padded along axis 0 to ``width``."""
    out = np.full((len(arrs), width, *arrs[0].shape[1:]), value,
                  dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        n = min(len(a), width)
        out[i, :n] = a[:n]
    return out


def collate_list(x_list: list[np.ndarray], buckets: tuple[int, ...] | None = None,
                 pad_value: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """pad_sequence + lengths, bucket-padded."""
    lens = np.asarray([len(x) for x in x_list], dtype=np.int64)
    width = int(lens.max())
    if buckets:
        width = bucket_for(width, buckets)
    return pad_to(x_list, width, pad_value), lens


@dataclass
class ValleARCollate:
    """AR batch: input = BOS + codes[0]; target = codes[0] + EOS."""
    config: ConfigValle

    def __call__(self, batch: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        codes_list, targets_list, tokens_list = [], [], []
        for item in batch:
            c0 = np.asarray(item['codes'])[0]          # first codebook, (T,)
            codes_list.append(np.concatenate([[self.config.bos_token], c0]).astype(np.int32))
            targets_list.append(np.concatenate([c0, [self.config.eos_token]]).astype(np.int32))
            tokens_list.append(np.asarray(item['tokens'], np.int32))
        buckets = self.config.bucket_sizes
        codes, codes_lens = collate_list(codes_list, buckets)
        target, _ = collate_list(targets_list, buckets)
        tokens, tokens_lens = collate_list(tokens_list, buckets)
        assert (codes_lens > tokens_lens).all(), \
            'Codes length must be greater than tokens length.'
        return {'codes': codes, 'codes_lens': codes_lens, 'target': target,
                'tokens': tokens, 'tokens_lens': tokens_lens}


@dataclass
class ValleASRCollate:
    """ASR batch: the source prefix ('tokens') carries the first-codebook codec
    tokens, the causal target ('codes') the phonemes with the ASR specials
    (BOS = vocab_size + 1, EOS = vocab_size)."""
    config: ConfigValle

    def __call__(self, batch: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        bos = self.config.vocab_size + 1
        eos = self.config.vocab_size
        src_list, tgt_in_list, tgt_out_list = [], [], []
        for item in batch:
            phonemes = np.asarray(item['tokens'], np.int32)
            src_list.append(np.asarray(item['codes'])[0].astype(np.int32))
            tgt_in_list.append(np.concatenate([[bos], phonemes]).astype(np.int32))
            tgt_out_list.append(np.concatenate([phonemes, [eos]]).astype(np.int32))
        buckets = self.config.bucket_sizes
        tokens, tokens_lens = collate_list(src_list, buckets)     # codec tokens
        codes, codes_lens = collate_list(tgt_in_list, buckets)    # BOS+phonemes
        target, _ = collate_list(tgt_out_list, buckets)
        return {'codes': codes, 'codes_lens': codes_lens, 'target': target,
                'tokens': tokens, 'tokens_lens': tokens_lens}


@dataclass
class ValleNARCollate:
    """NAR batch: full codes, time-major (T, nq) per item, + tokens."""
    config: ConfigValle

    def __call__(self, batch: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        codes_list = [np.ascontiguousarray(np.asarray(item['codes']).T).astype(np.int32)
                      for item in batch]               # (T, nq)
        tokens_list = [np.asarray(item['tokens'], np.int32) for item in batch]
        buckets = self.config.bucket_sizes
        codes, codes_lens = collate_list(codes_list, buckets)
        tokens, tokens_lens = collate_list(tokens_list, buckets)
        assert (codes_lens > tokens_lens).all(), \
            'Codes length must be greater than tokens length.'
        return {'codes': codes, 'codes_lens': codes_lens,
                'tokens': tokens, 'tokens_lens': tokens_lens}
