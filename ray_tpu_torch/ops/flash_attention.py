"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Port of ``ray_tpu/ops/flash_attention.py``'s forward (the Pallas
``_fwd_kernel``). Blocked attention with an online softmax: the running
max, the denominator and the output accumulator are float32, the
[seq, seq] logits never exist in device memory, and GQA reads kv head
``h // n_rep`` with no repeat. The causal mask keeps ``k_pos <= q_pos``
aligned at the TOP LEFT, as the TPU kernel does; this differs from
``reference_attention``'s bottom-right mask when ``sq != skv``. A row with
no visible key gets output 0 and lse -inf.

- A CPU tensor goes to ``flash_fwd_plain``, a blocked loop in plain
  PyTorch that computes what the kernel computes.
- A CUDA tensor goes to the kernel (``csrc/flash_fwd.cu``, built at first
  use by ``ray_tpu_torch._kernels``), or the call raises. There is no
  fallback.

The kernel masks a ragged tail, so any sequence length works: a superset
of what the JAX package accepts, which requires multiples of 128 or one
whole-sequence block. ``block_q``/``block_k`` are TPU tiling arguments,
kept in the signature and ignored; the kernel picks its own tiles.

The backward kernels (dQ, dK/dV) are not ported yet; ``flash_fwd`` with
``with_lse=True`` is the forward they will pair with.
"""

from __future__ import annotations

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
_HEAD_DIMS = (64, 128, 256)


def flash_fwd_plain(q, k, v, *, scale: float, causal: bool = True,
                    with_lse: bool = False, block_q: int = 64,
                    block_k: int = 64):
    """The plain PyTorch version of the kernel, on the kernel layout:
    q [b, h, sq, d], k and v [b, hk, skv, d]. Returns (out [b, h, sq, d] in
    q's dtype, lse [b, h, sq] float32 or None)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    n_rep = h // k.shape[1]
    kx = k.repeat_interleave(n_rep, dim=1).float()
    vx = v.repeat_interleave(n_rep, dim=1)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qb = q[:, :, q0:q1].float()
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((b, h, q1 - q0, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, q1 - q0, 1), device=q.device)
        acc = torch.zeros((b, h, q1 - q0, d), device=q.device)
        for k0 in range(0, skv, block_k):
            if causal and k0 > q0 + block_q - 1:
                break   # kv blocks past the causal limit are skipped
            k1 = min(k0 + block_k, skv)
            s = (qb @ kx[:, :, k0:k1].transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(k0, k1, device=q.device)[None, :]
                s = s.masked_fill(k_pos > q_pos, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            # a row with no visible key so far keeps p = 0, not exp(nan)
            base = torch.where(m_new == float("-inf"),
                               torch.zeros_like(m_new), m_new)
            p = torch.exp(s - base)
            corr = torch.exp(m - base)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ \
                vx[:, :, k0:k1].float()
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, q0:q1] = (acc / l_safe).to(q.dtype)
        if with_lse:
            lse[:, :, q0:q1] = torch.where(
                l == 0.0, torch.full_like(l, float("-inf")),
                m + torch.log(l_safe))[..., 0]
    return out, lse


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel's 16-byte loads can read it (head dim
    contiguous, strides and address aligned), else an aligned copy."""
    vec = _VEC[x.dtype]
    if (x.stride(-1) == 1 and all(s % vec == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, out, lse, *, seq_dim: int, head_dim: int,
            scale: float, causal: bool):
    """Launch the CUDA kernel on 4-d tensors whose sequence and head axes
    are ``seq_dim`` and ``head_dim`` (the last axis is the head dim)."""
    from ray_tpu_torch import _kernels

    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"flash_fwd: {name} must match q's device and "
                             f"dtype, got {x.device}/{x.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_fwd kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    d = q.shape[-1]
    if d not in _HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"flash_fwd kernel takes head_dim in {_HEAD_DIMS} "
                         f"and matching k/v, got q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    b, h, hk = q.shape[0], q.shape[head_dim], k.shape[head_dim]
    if h % hk:
        raise ValueError(f"flash_fwd: {h} q heads not a multiple of {hk} "
                         "kv heads")
    sq, skv = q.shape[seq_dim], k.shape[seq_dim]
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)

    def strides(x):
        return (x.stride(0), x.stride(seq_dim), x.stride(head_dim))

    lib = _kernels.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _KERNEL_DTYPES[q.dtype], b, h, hk, sq, skv, d,
            *strides(q), *strides(k), *strides(v), *strides(out),
            float(scale), int(causal), stream)
    _kernels.check(err, "flash_fwd kernel launch")
    flash_fwd.launches += 1


def flash_fwd(q, k, v, *, scale: float | None = None, causal: bool = True,
              with_lse: bool = False):
    """Flash forward on the kernel layout: q [b, h, sq, d], k and v
    [b, hk, skv, d]. Returns (out [b, h, sq, d] in q's dtype, lse
    [b, h, sq] float32 when ``with_lse`` else None). This is the entry the
    training backward and ring attention call."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                               with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch(q, k, v, out, lse, seq_dim=2, head_dim=1, scale=scale,
            causal=causal)
    return out, lse


# kernel launches since the last reset (the plain version never counts)
flash_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, block_q: int | None = None,
                    block_k: int | None = None):
    """Flash attention on [batch, seq, heads, head_dim] (the layout of
    ``reference_attention``); returns [batch, seq, heads, head_dim]. On
    CUDA the kernel reads this layout through strides, with no transpose.
    ``block_q``/``block_k`` are accepted for the JAX signature and
    ignored."""
    del block_q, block_k
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        out, _ = flash_fwd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale=scale,
                                 causal=causal)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, None, seq_dim=1, head_dim=2, scale=scale,
            causal=causal)
    return out
