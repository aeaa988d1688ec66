"""Data: the text frontend, bucketed collate and the synthetic training
dataset (copied from ``valle2_tpu/data``: pure Python and numpy)."""

from .collate import (ValleARCollate, ValleASRCollate, ValleNARCollate, collate_list,
                      get_collate)
from .dataset import DataLoader, SyntheticValleDataset, get_dataloaders
from .frontend import PHONEMES, PUNCTUATION, PhonemeTokenizer, split_sentences

__all__ = ['ValleARCollate', 'ValleASRCollate', 'ValleNARCollate', 'collate_list',
           'get_collate', 'DataLoader', 'SyntheticValleDataset', 'get_dataloaders',
           'PHONEMES', 'PUNCTUATION', 'PhonemeTokenizer', 'split_sentences']
