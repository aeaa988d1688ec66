"""EnCodec decode (SEANet decoder + residual VQ lookup) for PyTorch."""

from .encodec import (CODEBOOK_SIZE, HOP, LATENT_DIM, NUM_QUANTIZERS, SAMPLE_RATE,
                      Encodec, decode, init_params)
from .rvq import rvq_decode, rvq_init

__all__ = ['CODEBOOK_SIZE', 'HOP', 'LATENT_DIM', 'NUM_QUANTIZERS', 'SAMPLE_RATE',
           'Encodec', 'decode', 'init_params', 'rvq_decode', 'rvq_init']
