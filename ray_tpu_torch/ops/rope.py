"""Rotary position embeddings (RoPE), Llama-3 style.

Port of ``ray_tpu/ops/rope.py``: split-half convention, computed in
float32 and cast back to the input's dtype.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 500000.0,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary embedding, [head_dim // 2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return (1.0 / (theta ** exponent)).to(dtype)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, *,
                 theta: float = 500000.0):
    """(sin, cos) tables [..., head_dim // 2] for integer positions [...],
    in float32 on the positions' device."""
    inv_freq = rope_frequencies(head_dim, theta=theta,
                                device=positions.device)
    angles = positions[..., None].float() * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate q or k: x is [..., seq, heads, head_dim]; sin/cos are
    [..., seq, head_dim // 2] (broadcast over the heads axis)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
