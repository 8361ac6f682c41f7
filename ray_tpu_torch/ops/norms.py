"""Normalization ops: float32 statistics inside bf16 models.

Port of ``ray_tpu/ops/norms.py``.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 statistics regardless of input dtype; the
    result is cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias=None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm, float32 statistics, optional bias."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
