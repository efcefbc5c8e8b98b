"""PyTorch + CUDA port of ``lam_slide_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``nn/``, ``ops/``, ``models/``,
``transport/``) one module at a time; ``csrc/`` holds the hand-written CUDA
kernels that replace the JAX package's Pallas kernels. This package imports
``torch`` and never ``jax``, ``flax`` or ``lam_slide_tpu``: the machine that
runs it has no JAX.

Kernel policy: every kernel wrapper runs its plain PyTorch version on CPU
tensors and launches its CUDA kernel on CUDA tensors. A CUDA call that the
kernel cannot take raises; nothing falls back.
"""
