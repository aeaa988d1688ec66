"""Text frontend (copied from ``valle2_tpu/data``: pure Python and numpy)."""

from .frontend import PHONEMES, PUNCTUATION, PhonemeTokenizer, split_sentences

__all__ = ['PHONEMES', 'PUNCTUATION', 'PhonemeTokenizer', 'split_sentences']
