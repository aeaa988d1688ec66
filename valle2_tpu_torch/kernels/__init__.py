"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Built from ``valle2_tpu_torch/csrc`` on first use (``_build``); importing this
package needs no CUDA toolchain.
"""
