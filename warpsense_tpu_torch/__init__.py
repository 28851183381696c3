"""warpsense_tpu_torch — the warpsense LiDAR SLAM engine on PyTorch and CUDA.

The port of ``warpsense_tpu`` (JAX) to PyTorch with hand-written CUDA C++
kernels for Hopper (``csrc/``).  Module paths and function names mirror the
JAX package so each counterpart is easy to find; inside, the code is plain
functions on tensors with an explicit ``device`` argument.

Nothing here imports ``jax``: the JAX package is the test oracle only.
"""
import torch as _torch

# SLAM math (Rodrigues, 6x6 solves, J^T J) is precision-sensitive: keep
# float32 products in full float32 on the card (TF32 keeps ~3 digits).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
