"""Data: the text frontend, bucketed collate, the audio dataset tokenized
through the codec and the synthetic training dataset (``valle2_tpu/data``)."""

from .collate import (ValleARCollate, ValleASRCollate, ValleNARCollate, collate_list,
                      get_collate)
from .dataset import DataLoader, SyntheticValleDataset, ValleDataset, get_dataloaders
from .frontend import PHONEMES, PUNCTUATION, PhonemeTokenizer, split_sentences

__all__ = ['ValleARCollate', 'ValleASRCollate', 'ValleNARCollate', 'collate_list',
           'get_collate', 'DataLoader', 'SyntheticValleDataset', 'ValleDataset',
           'get_dataloaders',
           'PHONEMES', 'PUNCTUATION', 'PhonemeTokenizer', 'split_sentences']
