"""Products with a float32 result from low-precision operands.

JAX writes ``jnp.einsum(..., preferred_element_type=jnp.float32)`` where a
product's float32 accumulator must reach the next operation unrounded (an
LM head's logits, the MoE experts' gate and up products before SwiGLU).
``matmul_f32`` is that product for the port.
"""

from __future__ import annotations

import torch


class _MatmulF32(torch.autograd.Function):
    """``torch.mm``/``torch.bmm`` with a float32 output type, which have no
    derivative of their own: the backward rounds the float32 cotangent to
    the operands' dtype and runs the two transposed products in that
    dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        product = torch.mm if x.dim() == 2 else torch.bmm
        return product(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.transpose(-1, -2), x.transpose(-1, -2) @ g


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result: the float32 accumulator is written
    out as it is, never rounded to the operands' dtype. ``x`` [..., k] with
    ``w`` [k, n], or ``x`` [e, m, k] with ``w`` [e, k, n] (a product per
    leading index, as for the MoE experts). On CUDA, low-precision operands
    go to one GEMM with a float32 output type, with no float32 copy of
    either operand (2 GB for Llama-3-8B's LM head); elsewhere both widen
    first."""
    if x.is_cuda and x.dtype != torch.float32 and w.dtype == x.dtype:
        if w.dim() == 3:
            return _MatmulF32.apply(x, w)
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()
