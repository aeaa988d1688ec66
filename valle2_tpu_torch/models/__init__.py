"""VALL-E AR / NAR models (decode and training) for PyTorch, and the model
registry of ``valle2_tpu/models/__init__.py``: ``MODEL_DICT`` names the
codec (``'EncodecPip'``, the reference's name, and ``'EncodecTPU'``, the JAX
package's, both the port's ``codec.Encodec``), ``'ValleAR'``, ``'ValleNAR'``
and ``'ValleASR'``, the direction-swapped AR."""

import dataclasses

from ..codec import Encodec
from .ar import ValleAR
from .nar import ValleNAR


def _asr(config, *args, **kwargs):
    if config.direction != 'asr':
        config = dataclasses.replace(config, direction='asr')
    return ValleAR(config, *args, **kwargs)


MODEL_DICT = {
    'EncodecPip': Encodec,
    'EncodecTPU': Encodec,
    'ValleAR': ValleAR,
    'ValleNAR': ValleNAR,
    'ValleASR': _asr,
}


def get_model_class(model_name: str):
    return MODEL_DICT[model_name]


__all__ = ['Encodec', 'MODEL_DICT', 'ValleAR', 'ValleNAR', 'get_model_class']
