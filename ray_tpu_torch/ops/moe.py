"""Mixture-of-Experts ops: top-k router with per-expert capacity and the
SwiGLU expert FFN.

Port of ``ray_tpu/ops/moe.py``: GShard-style routing, where dispatch and
combine are products with one-hot capacity tensors ``[T, E, C]`` (static
shapes, no gather). The JAX functions are XLA einsums, not Pallas kernels;
here they are ``torch`` products with float32 accumulators
(``ops.matmul.matmul_f32``), each rounded to x's dtype where JAX rounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ray_tpu_torch.ops.matmul import matmul_f32


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values, descending,
    the lower index first among equal values. A stable descending sort
    keeps equal values in index order on every device (``torch.topk``
    promises no order for ties on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(logits: torch.Tensor, *, top_k: int, capacity: int):
    """Top-k gating with per-expert capacity (GShard), on router logits
    [T, E]. Returns (dispatch [T, E, C] of 0/1, combine [T, E, C] of the
    renormalized gate weights, aux_loss scalar), all float32. A token's
    place in its expert's queue is the number of earlier tokens sent
    there: slot 0 for every token first, then slot 1, the counts carried
    between slots. Tokens past capacity are dropped (combine weight 0: the
    residual stream carries them unchanged)."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    dev = logits.device
    rows = torch.arange(t, device=dev)
    experts = torch.arange(e, device=dev)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(e, dtype=torch.int32, device=dev)
    for slot in range(top_k):
        idx = gate_idx[:, slot]
        # one-hot [E, T]: the running count is a scan along the contiguous
        # token axis (a scan over the outer axis of [T, E] is slow on CUDA)
        onehot = (experts[:, None] == idx[None, :]).int()
        before = onehot.cumsum(1, dtype=torch.int32) - onehot
        pos = before.gather(0, idx[None, :])[0] + counts[idx]
        keep = (pos < capacity).float()
        # each token's one entry of this slot (a dropped token adds 0)
        at = (rows, idx, pos.clamp(max=capacity - 1).long())
        dispatch = dispatch.index_put(at, keep, accumulate=True)
        combine = combine.index_put(at, keep * gate_vals[:, slot],
                                    accumulate=True)
        counts = counts + onehot.sum(1, dtype=torch.int32)

    # load-balancing loss E * sum(f_i * p_i), f_i counting ALL top-k
    # assignments: an expert that is every token's second choice still
    # feels the pressure
    me = probs.mean(0)
    ce = F.one_hot(gate_idx, e).float().sum(1).mean(0) / top_k
    aux_loss = e * (me * ce).sum()
    return dispatch, combine, aux_loss


def moe_ffn(x, router_w, wi_gate, wi_up, wo, *, top_k: int = 2,
            capacity_factor: float = 1.25):
    """SwiGLU expert FFN with top-k routing on tokens x [T, D], router_w
    [D, E] (float32), wi_gate and wi_up [E, D, F], wo [E, F, D]. Returns
    (out [T, D] in x's dtype, aux_loss). Every product accumulates in
    float32; dispatch, combine, the experts' inputs, their hidden
    activations, their outputs and the result are rounded to x's dtype
    where JAX rounds them (so bf16 rounding of the gate weights is part of
    the function)."""
    t, d = x.shape
    e = router_w.shape[1]
    capacity = max(1, int(capacity_factor * t * top_k / e))
    dtype = x.dtype
    # the profiler's ranges: the time of each part in a trace
    with record_function("moe.router"):
        logits = x.float() @ router_w.float()
        dispatch, combine, aux = router_topk(logits, top_k=top_k,
                                             capacity=capacity)
    with record_function("moe.dispatch"):
        flat_dispatch = dispatch.to(dtype).reshape(t, e * capacity)
        expert_in = matmul_f32(flat_dispatch.T, x).to(dtype) \
            .reshape(e, capacity, d)                             # "ecd"
    with record_function("moe.experts"):
        h = (F.silu(matmul_f32(expert_in, wi_gate))
             * matmul_f32(expert_in, wi_up)).to(dtype)           # "ecf"
        expert_out = matmul_f32(h, wo).to(dtype)                 # "ecd"
    with record_function("moe.combine"):
        out = matmul_f32(combine.to(dtype).reshape(t, e * capacity),
                         expert_out.reshape(e * capacity, d))
    return out.to(dtype), aux
