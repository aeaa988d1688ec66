"""VALL-E AR / NAR models (decode and training) for PyTorch."""

from .ar import ValleAR
from .nar import ValleNAR

__all__ = ['ValleAR', 'ValleNAR']
