"""VALL-E AR / NAR models (decode paths) for PyTorch."""

from .ar import ValleAR
from .nar import ValleNAR

__all__ = ['ValleAR', 'ValleNAR']
