"""Autograd helpers of the kernel wrappers (no JAX counterpart).

A kernel writes its outputs through raw pointers, so PyTorch's autograd
cannot see through it: every wrapper that launches a kernel on tensors that
need a gradient does so inside a ``torch.autograd.Function``, the
counterpart of the JAX package's ``jax.custom_vjp``.
"""

from typing import Callable, Sequence, Tuple

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd is recording and any tensor argument requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def plain_vjp(fn: Callable, inputs: Sequence, needs_input_grad: Sequence[bool],
              grad_outputs: Sequence[torch.Tensor]) -> Tuple:
    """Gradients of ``fn(*inputs)`` by autograd of a plain version: recompute
    it on detached copies of the inputs that need a gradient, then
    ``torch.autograd.grad`` (JAX: ``jax.vjp`` of the reference inside a
    custom VJP's backward). Returns one entry per input, None where no
    gradient was asked for."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_() if need else t
                for t, need in zip(inputs, needs_input_grad)]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [a for a, need in zip(args, needs_input_grad) if need]
        grads = iter(torch.autograd.grad(outs, wrt, grad_outputs, allow_unused=True)
                     if wrt else ())
    return tuple(next(grads) if need else None for need in needs_input_grad)
