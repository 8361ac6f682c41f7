"""Flash attention: hand-written CUDA kernels, their plain versions, and the
gradient that joins them.

Port of ``ray_tpu/ops/flash_attention.py``: the forward (the Pallas
``_fwd_kernel``, K1), the dQ backward (``_bwd_dq_kernel``, K2) and the
dK/dV backward (``_bwd_dkv_kernel``, K3), with the custom VJP
(``_flash``) that runs the forward with its log-sum-exp, saves
``(q, k, v, out, lse)`` and runs both backward kernels.

- Forward: blocked attention with an online softmax. The running max, the
  denominator and the output accumulator are float32, the [seq, seq]
  logits never exist in device memory, and GQA reads kv head
  ``h // n_rep`` with no repeat. The causal mask keeps ``k_pos <= q_pos``
  aligned at the TOP LEFT, as the TPU kernel does; this differs from
  ``reference_attention``'s bottom-right mask when ``sq != skv``. A row
  with no visible key gets output 0 and lse -inf.
- Backward: P = exp(S - lse) is recomputed block by block, with
  delta = rowsum(dO * O) summed in float64. dQ sums over kv blocks; dK
  and dV sum over q blocks and over the whole GQA group, so they come out
  kv-head shaped. P is rounded to dO's dtype before dV and dS to K's
  (Q's) before dQ (dK), as on the TPU. A row with lse -inf gets a zero
  gradient (JAX computes exp(-inf - -inf) = nan there; the top-left
  causal mask never makes such a row). On the card K2 and K3 are one
  fused kernel, which adds each kv tile's share of dQ into a float32
  buffer: dQ's summation order changes from run to run, dK and dV are
  summed in registers and come out the same every run.

Each kernel has a wrapper (``flash_fwd``/``_forward``; ``flash_bwd`` for
K2 and K3 together) that takes its plain version (``flash_fwd_plain``;
``flash_bwd_dq_plain`` with ``flash_bwd_dkv_plain``, blocked loops in
plain PyTorch) for a CPU tensor, and for a CUDA tensor launches the
kernel (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, built at first use
by ``ray_tpu_torch._kernels``) or raises. There is no fallback. Each
wrapper counts its kernel launches in ``<wrapper>.launches``;
``flash_fwd.calls`` counts the forward's runs on either device (the remat
tests read it).

The gradient: the forward and the backward are ``torch.library``
operators (``ray_tpu_torch::flash_fwd``, ``ray_tpu_torch::flash_bwd``)
joined by ``register_autograd``. Being operators, they are visible to
selective activation checkpointing, which can then save ``out`` and
``lse`` by name (the ``attn`` remat policies of ``models/llama.py``), so
the backward never reruns K1. On the CPU the same seam runs the plain
versions, so a CPU backward goes through the backward plain versions,
not through autograd of the forward loop.

The kernels mask ragged tails, so any sequence length works: a superset
of what the JAX package accepts, which requires multiples of 128 or one
whole-sequence block. ``block_q``/``block_k`` are TPU tiling arguments,
kept in the signature and ignored; the kernels pick their own tiles.
"""

from __future__ import annotations

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
_HEAD_DIMS = (64, 128, 256)
_NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Plain versions (kernel layout: q [b, h, sq, d], k and v [b, hk, skv, d])
# ---------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, *, scale: float, causal: bool = True,
                    with_lse: bool = False, block_q: int = 64,
                    block_k: int = 64):
    """The plain PyTorch version of K1, on the kernel layout:
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


def _probs(s, lse, q_pos, k_pos, causal):
    """P = exp(S - lse) under the top-left causal mask; a row with lse -inf
    (no visible key) gets P = 0."""
    if causal:
        s = s.masked_fill(k_pos > q_pos, _NEG_INF)
    lse = torch.where(lse == _NEG_INF, torch.full_like(lse, float("inf")),
                      lse)
    return torch.exp(s - lse)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, scale: float,
                       causal: bool = True, block_q: int = 64,
                       block_k: int = 64):
    """The plain PyTorch version of K2: dQ [b, h, sq, d] in q's dtype from
    q and dO [b, h, sq, d], k and v [b, hk, skv, d], lse and delta
    [b, h, sq] float32."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    n_rep = h // k.shape[1]
    kx = k.repeat_interleave(n_rep, dim=1)
    vx = v.repeat_interleave(n_rep, dim=1).float()
    dq = torch.empty_like(q)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qb, dob = q[:, :, q0:q1].float(), do[:, :, q0:q1].float()
        lb, db = lse[:, :, q0:q1, None], delta[:, :, q0:q1, None]
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        acc = torch.zeros((b, h, q1 - q0, d), device=q.device)
        for k0 in range(0, skv, block_k):
            if causal and k0 > q1 - 1:
                break
            k1 = min(k0 + block_k, skv)
            kb = kx[:, :, k0:k1]
            s = (qb @ kb.float().transpose(-1, -2)) * scale
            p = _probs(s, lb, q_pos,
                       torch.arange(k0, k1, device=q.device)[None, :], causal)
            dp = dob @ vx[:, :, k0:k1].transpose(-1, -2)
            ds = p * (dp - db) * scale
            acc += ds.to(k.dtype).float() @ kb.float()
        dq[:, :, q0:q1] = acc.to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale: float,
                        causal: bool = True, block_q: int = 64,
                        block_k: int = 64):
    """The plain PyTorch version of K3: (dK, dV) [b, hk, skv, d] in k's and
    v's dtypes, each summed over the q heads of its GQA group."""
    b, hk, skv, d = k.shape
    h, sq = q.shape[1], q.shape[2]
    n_rep = h // hk
    # [b, hk, n_rep, s, ...]: q head hk * n_rep + r is group hk, member r
    qg, dog = q.unflatten(1, (hk, n_rep)), do.unflatten(1, (hk, n_rep))
    lg, dg = lse.unflatten(1, (hk, n_rep)), delta.unflatten(1, (hk, n_rep))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, skv, block_k):
        k1 = min(k0 + block_k, skv)
        kb = k[:, :, None, k0:k1].float()
        vb = v[:, :, None, k0:k1].float()
        k_pos = torch.arange(k0, k1, device=k.device)[None, :]
        acc_k = torch.zeros((b, hk, k1 - k0, d), device=k.device)
        acc_v = torch.zeros((b, hk, k1 - k0, d), device=k.device)
        for q0 in range(0, sq, block_q):
            q1 = min(q0 + block_q, sq)
            if causal and q1 - 1 < k0:
                continue   # the q block ends before this kv block starts
            qb, dob = qg[:, :, :, q0:q1], dog[:, :, :, q0:q1]
            s = (qb.float() @ kb.transpose(-1, -2)) * scale
            p = _probs(s, lg[:, :, :, q0:q1, None],
                       torch.arange(q0, q1, device=k.device)[:, None], k_pos,
                       causal)
            acc_v += (p.to(do.dtype).float().transpose(-1, -2)
                      @ dob.float()).sum(dim=2)
            dp = dob.float() @ vb.transpose(-1, -2)
            ds = p * (dp - dg[:, :, :, q0:q1, None]) * scale
            acc_k += (ds.to(q.dtype).float().transpose(-1, -2)
                      @ qb.float()).sum(dim=2)
        dk[:, :, k0:k1] = acc_k.to(k.dtype)
        dv[:, :, k0:k1] = acc_v.to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it through its strides (head
    dim contiguous; the other strides multiples of 16 bytes, and not 0
    where the extent is above 1, as TMA's tensor maps need; address 16-byte
    aligned), else an aligned copy."""
    vec = _VEC[x.dtype]
    if (x.stride(-1) == 1
            and all(s % vec == 0 and (s > 0 or n == 1)
                    for s, n in zip(x.stride()[:-1], x.shape[:-1]))
            and x.data_ptr() % 16 == 0):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_operands(what, q, k, v, *more):
    """Raise on what the kernels do not take: other devices or dtypes
    than q's, a dtype other than float32/bfloat16, a head dim outside
    (64, 128, 256), q heads not a multiple of kv heads (kernel layout)."""
    for name, x in (("k", k), ("v", v), *more):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{what}: {name} must match q's device and "
                             f"dtype, got {x.device}/{x.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    d = q.shape[-1]
    if d not in _HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{what} kernel takes head_dim in {_HEAD_DIMS} "
                         f"and matching k/v, got q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{what}: {q.shape[1]} q heads not a multiple of "
                         f"{k.shape[1]} kv heads")


def _strides(x):
    """Batch, sequence and head strides of a kernel-layout tensor."""
    return (x.stride(0), x.stride(2), x.stride(1))


def _shape_args(q, k):
    b, h, sq, d = q.shape
    return (_KERNEL_DTYPES[q.dtype], b, h, k.shape[1], sq, k.shape[2], d)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(q, k, v, out, lse, *, scale: float, causal: bool):
    from ray_tpu_torch import _kernels

    _check_operands("flash_fwd", q, k, v)
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    lib = _kernels.load("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.rt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, *_shape_args(q, k),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            float(scale), int(causal), _stream(q))
    _kernels.check(err, "flash_fwd kernel launch")
    flash_fwd.launches += 1


def _forward(q, k, v, scale: float, causal: bool, with_lse: bool):
    """One run of the forward: K1 on CUDA, its plain version on the CPU.
    ``out`` takes q's layout, so a transposed [b, s, h, d] view gives an
    output that is contiguous as [b, s, h, d]."""
    flash_fwd.calls += 1
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                               with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch_fwd(q, k, v, out, lse, scale=scale, causal=causal)
    return out, lse


def _launch_bwd(q, k, v, out, lse, do, *, scale: float, causal: bool):
    """K2 and K3 as one launch of ``rt_flash_bwd`` (a preprocess for
    delta, the fused kernel, a postprocess for dQ): (dq, dk, dv)."""
    from ray_tpu_torch import _kernels

    _check_operands("flash_bwd", q, k, v, ("out", out), ("do", do))
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3] or \
            lse.device != q.device:
        raise ValueError(f"flash_bwd: lse must be float32 {tuple(q.shape[:3])}"
                         f" on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    q, k, v, out, do = (_kernel_operand(x) for x in (q, k, v, out, do))
    lse = lse.contiguous()
    b, h, sq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if sq == 0 or k.shape[2] == 0:   # nothing to launch: no pair of (q, k)
        return dq.zero_(), dk.zero_(), dv.zero_()
    # float32 scratch: lse in base 2 and delta, a row each padded to whole
    # 64-row q tiles, and for bf16 the dQ accumulator (see rt_flash_bwd)
    bf16 = q.dtype == torch.bfloat16
    ld = -(-sq // 64) * 64 if bf16 else sq
    work = torch.empty(b * h * ld * (2 + (d if bf16 else 0)),
                       dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.rt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_shape_args(q, k), *_strides(q),
            *_strides(k), *_strides(v), *_strides(out), *_strides(do),
            *_strides(dq), *_strides(dk), *_strides(dv), float(scale),
            int(causal), _stream(q))
    _kernels.check(err, "flash_bwd kernel launch")
    flash_bwd.launches += 1
    return dq, dk, dv


def flash_bwd_delta(out, do):
    """delta = rowsum(dO * O) [b, h, sq] float32, summed in float64 as the
    kernel's preprocess sums it: dS = P (dP - delta) cancels, so a float32
    sum in another order would move dQ by more than float32 rounding."""
    return (do.double() * out.double()).sum(dim=-1).float()


def flash_bwd(q, k, v, out, lse, do, *, scale: float, causal: bool = True):
    """The backward on the kernel layout, the counterpart of JAX's
    ``_flash_bwd``: (dq, dk, dv) from the forward's inputs, its output and
    lse, and the output's cotangent ``do``. On the card one launch of the
    fused kernel computes all three; on the CPU delta = rowsum(dO * O) and
    K2's and K3's plain versions, which together are its plain version.
    Ring attention calls this with ``causal=False`` off the diagonal."""
    do = do.to(q.dtype)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, do, scale=scale, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    delta = flash_bwd_delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale,
                            causal=causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                                 causal=causal)
    return dq, dk, dv


# fused backward launches since the last reset (the plain versions never
# count)
flash_bwd.launches = 0


# ---------------------------------------------------------------------------
# The differentiable forward: two operators joined by register_autograd
# ---------------------------------------------------------------------------

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return _forward(q, k, v, scale, causal, True)


@torch.library.custom_op("ray_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float, causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_bwd(q, k, v, out, lse, do, scale=scale, causal=causal)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, scale, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale, ctx.causal = scale, causal
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, out, lse, dout, ctx.scale,
                               ctx.causal)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)

# the operator overload that selective checkpointing saves (its outputs
# are out and lse: the backward's residuals)
FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_fwd(q, k, v, *, scale: float | None = None, causal: bool = True,
              with_lse: bool = False):
    """Flash forward on the kernel layout: q [b, h, sq, d], k and v
    [b, hk, skv, d]. Returns (out [b, h, sq, d] in q's dtype, lse
    [b, h, sq] float32 when ``with_lse`` else None). Differentiable in
    q, k and v (lse is not); a call that needs no gradient runs the
    forward alone."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        out, lse = _flash_fwd_op(q, k, v, float(scale), bool(causal))
        return out, (lse if with_lse else None)
    return _forward(q, k, v, scale, causal, with_lse)


# K1 launches and forward runs (either device) since the last reset
flash_fwd.launches = 0
flash_fwd.calls = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, block_q: int | None = None,
                    block_k: int | None = None):
    """Flash attention on [batch, seq, heads, head_dim] (the layout of
    ``reference_attention``); returns [batch, seq, heads, head_dim],
    differentiable in q, k and v. The kernels read this layout through
    strides, with no transpose. ``block_q``/``block_k`` are accepted for
    the JAX signature and ignored."""
    del block_q, block_k
    out, _ = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), scale=scale, causal=causal)
    return out.transpose(1, 2)
