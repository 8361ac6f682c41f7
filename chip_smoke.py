#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all started together), checks that the binaries of
K1 and of the fused backward (K2 and K3) are the Hopper design (wgmma and
TMA instructions in their SASS, no spill, no ptxas note that setmaxnreg
was ignored or wgmma serialized), holds each kernel against its plain
PyTorch version at the shapes the main path gives it (timed by CUDA-graph
replay, as a wrapper's host work per call can exceed the kernel's time
on the card), then drives
the main path at the full width of Llama-3-8B with seeded random weights:
the full 32-layer forward over 2048 tokens, the paged serving engine
answering 10 requests, the model's gradient through the flash kernels at
depth 2 against the same gradient through reference attention, and the
trainer taking steps on the full 32-layer model. Then the other model
families, each at its published width and one after another on the
card's memory: GPT-2 XL at full depth (the forward and the gradient
through the kernels against reference attention, trainer steps), BERT-large
trained through the trainer's loss hook (no kernel runs there), ViT-L/16
in float32 (forward and Adam steps), the last two also held against the
CPU at depth 2, and Mixtral 8x7B at depths 16, 2 and 4 (the forward and
gradient against reference attention with the routing held fixed, AdamW
steps). Then the multi-process train harness, each phase spawning rank
processes over torch.distributed: Llama-3-8B at full depth through
TorchMeshTrainer on one NCCL rank fed by the device feed (its losses
against the one-process trainer's), two ranks on this card over gloo at
depth 4 (their parameters and gradient norms against the
single-controller trainer on {dp 2}, with controls that skip the
gradient all-reduce and that average in place of the sum), and
ElasticTrainer's reform from {dp 2, fsdp 2} to {dp 2} at depth 2. Every
phase prints one JSON line; the last line is the contract line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and that line is never printed. Without a CUDA card, or
without the rest of the repository beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# The forwards of the other families through K1 against reference
# attention, in relative RMS of the logits: both are bf16 models that
# differ only in attention's rounding points. Llama's 5e-2 would not
# separate a float8 attention at GPT-2 XL (its logits move by about
# 3.4e-2 there), so these limits sit at half of it, below every float8
# control (PERF.md section 2).
FAMILY_FORWARD_TOL = 2.5e-2
# Datasheet rates by card name, besides the dense bf16 peak (which comes
# from ray_tpu_torch/train/telemetry.py's PEAK_BF16_FLOPS, the repo's one
# table of card peaks): (float32 FLOP/s outside the tensor cores, device
# memory bytes/s). H100 SXM and PCIe data sheets.
CARD_RATES = {
    "H100 80GB HBM3": (67e12, 3.35e12),
    "H100 PCIe": (51e12, 2.0e12),
}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks_for(name: str):
    """(table key, (bf16 FLOP/s, float32 FLOP/s, memory bytes/s)) of the
    card called ``name``."""
    from ray_tpu_torch.train.telemetry import peak_flops_of

    bf16 = peak_flops_of(name)
    for key, (f32, mem) in CARD_RATES.items():
        if key in name and bf16 is not None:
            return key, (bf16, f32, mem)
    raise ValueError(f"no datasheet peaks for {name!r}: add the card to "
                     "CARD_RATES and telemetry.PEAK_BF16_FLOPS to work out "
                     "bound_ms")


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after one
    warm-up call, timed with CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls captured in
    one CUDA graph and replayed three times: the card's time with no host
    in the loop. A kernel that takes less time than its Python wrapper's
    host work is otherwise timed by the host (cuda_ms). Two warm-up calls
    run on a side stream first, as capture requires."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def attention_bound(b, h, hk, sq, skv, d, causal, itemsize, with_lse,
                    peaks):
    """The least time for one attention forward on this card: the larger
    of the FLOPs of the unmasked (q, k) pairs at the dtype's peak and the
    compulsory bytes (q, k, v read once, out and lse written once) at the
    memory rate."""
    rows = np.arange(sq)
    pairs = (np.minimum(rows + 1, skv).sum() if causal else sq * skv)
    flops = 4.0 * b * h * d * float(pairs)
    nbytes = itemsize * (2 * b * h * sq * d + 2 * b * hk * skv * d)
    if with_lse:
        nbytes += 4 * b * h * sq
    bf16_peak, f32_peak, mem_rate = peaks
    peak = bf16_peak if itemsize == 2 else f32_peak
    t_ops, t_bytes = flops / peak, nbytes / mem_rate
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| over all elements, in float64, summed a slice of
    2^24 elements at a time (no float64 copy of a large gradient)."""
    num = den = 0.0
    n = 1 << 24
    for x, y in zip(a.reshape(-1).split(n), b.reshape(-1).split(n)):
        x, y = x.double(), y.double()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return (num / den) ** 0.5


def row_rel_err(got, want) -> float:
    """The largest ||got_r - want_r|| / ||want_r|| over the output rows
    (one row per batch, head and query position), in float64. Every row
    weighs alike, so the small outputs of late causal rows (spread about
    i^-1/2 at row i) are held as tightly as the large early ones. A row
    whose wanted output is 0 must come out exactly 0."""
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def grad_row_err(got, want) -> float:
    """``row_rel_err`` for a gradient: the largest ||got_r - want_r|| /
    ||want_r|| over rows, with the denominator floored at 1e-2 of the RMS
    row norm. Some gradient rows are zero up to rounding (dQ of query 0
    under the causal mask: one visible key, so dS = P (dP - delta) = 0),
    and their relative error says nothing."""
    got, want = got.double(), want.double()
    norms = want.norm(dim=-1)
    floor = 1e-2 * float(norms.square().mean().sqrt())
    return float(((got - want).norm(dim=-1) / norms.clamp_min(floor)).max())


def dense_attention(qt, kt, vt, *, scale, causal, round_p=None,
                    drop_diag_from=None):
    """Plain attention over whole rows in float32 on the kernel layout,
    with the flash mask (top left): P = exp(S - rowmax), O = (P V) / rowsum
    P, in q's dtype. It rounds at other points than the kernel and its
    plain version. ``round_p`` rounds P before the P V product, and
    ``drop_diag_from`` hides each row's diagonal 64-key tile from that row
    on: deliberately wrong variants the K1 check must reject."""
    import torch

    n_rep = qt.shape[1] // kt.shape[1]
    k = kt.repeat_interleave(n_rep, dim=1).float()
    v = vt.repeat_interleave(n_rep, dim=1).float()
    s = (qt.float() @ k.transpose(-1, -2)) * scale
    sq, skv = s.shape[-2:]
    qp = torch.arange(sq, device=s.device)[:, None]
    kp = torch.arange(skv, device=s.device)[None, :]
    hide = (kp > qp) if causal else torch.zeros_like(kp > qp)
    if drop_diag_from is not None:
        hide = hide | ((kp // 64 == qp // 64) & (qp >= drop_diag_from))
    s = s.masked_fill(hide, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if round_p is not None:
        p = round_p(p)
    return ((p @ v) / l).to(qt.dtype)


def check_flash_controls(torch, case, qt, kt, vt, want, tol):
    """Show that K1's tolerance tells a right kernel from a subtly wrong
    one at ``case``'s shape: attention rounded at other points (float32
    probabilities) passes it; probabilities through float8 e4m3, the
    diagonal kv tile missing for the later half of the rows, and a scale
    2% off each fail it."""
    scale = qt.shape[-1] ** -0.5
    kw = dict(scale=scale, causal=True)
    variants = {
        "float32_probabilities": (dense_attention(qt, kt, vt, **kw), True),
        "p_float8_e4m3": (dense_attention(
            qt, kt, vt, round_p=lambda p: p.to(torch.float8_e4m3fn).float(),
            **kw), False),
        "diag_tile_dropped_late_rows": (dense_attention(
            qt, kt, vt, drop_diag_from=qt.shape[2] // 2, **kw), False),
        "scale_2pct_off": (dense_attention(
            qt, kt, vt, scale=scale * 1.02, causal=True), False),
    }
    errs = {}
    for name, (out, should_pass) in variants.items():
        err = row_rel_err(out, want)
        errs[name] = err
        if (err <= tol) != should_pass:
            raise AssertionError(
                f"K1 tolerance {tol} does not separate: {name} has row "
                f"relative error {err}, should {'pass' if should_pass else 'fail'}")
    emit("kernel_check_controls", case=case, row_rel_tol=tol,
         row_rel_err=errs)


def check_flash(torch, peaks):
    """Hold the flash kernel against its plain version. Returns the rows
    of every case by name: among them the main path's (the Llama-3-8B
    attention shape, no lse), the training step's (b 2, with lse), a ring
    step's (non-causal, with lse) and GPT-2 XL's training step's (b 8, 25
    heads, no GQA, d 64, with lse). The tolerance's controls run at the
    main shape and at GPT-2 XL's."""
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_fwd,
                                                   flash_fwd_plain)

    # Both sides accumulate in float32 and round the unnormalized
    # probabilities, then the output, to the input type at the same
    # points, so in bf16 they differ by an occasional ulp of the output
    # (readings in PERF.md: row errors of order 1e-3). float32: only the
    # summation order differs. check_flash_controls shows that the row
    # tolerance rejects subtly wrong attention.
    row_tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
    abs_tol = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
    lse_tol = 1e-4
    cases = [
        # (name, b, h, hk, sq, skv, d, dtype, causal, with_lse)
        ("llama3_8b", 1, 32, 8, 2048, 2048, 128, torch.bfloat16, True, False),
        ("llama3_8b_lse", 1, 32, 8, 2048, 2048, 128, torch.bfloat16, True,
         True),
        ("llama3_8b_noncausal", 1, 32, 8, 2048, 2048, 128, torch.bfloat16,
         False, False),
        # a ring step off the diagonal: an sp-4 chunk of Llama-3-8B's 8K
        # context, non-causal, with the lse the merge needs
        ("ring_chunk_noncausal_lse", 1, 32, 8, 2048, 2048, 128,
         torch.bfloat16, False, True),
        # the training step's shape: b 2, with lse (also the 1F1B
        # pipeline's microbatch of 2 rows)
        ("llama3_8b_train", 2, 32, 8, 2048, 2048, 128, torch.bfloat16, True,
         True),
        # a tp-2 rank's attention at fsdp 2: one row, 16 q and 4 kv heads
        ("llama3_8b_tp2", 1, 16, 4, 2048, 2048, 128, torch.bfloat16, True,
         True),
        ("d64_gqa1", 2, 8, 8, 1024, 1024, 64, torch.bfloat16, True, True),
        # GPT-2 XL's training step: an odd head count, a group of one
        ("gpt2_xl_train", 8, 25, 25, 1024, 1024, 64, torch.bfloat16, True,
         True),
        ("d256_gqa2", 1, 4, 2, 1024, 1024, 256, torch.bfloat16, True, True),
        # edge cases: ragged tails, sq != skv, a short d 256
        ("ragged_d128", 1, 2, 2, 200, 200, 128, torch.bfloat16, True, True),
        ("noncausal_ragged_d64", 1, 2, 1, 333, 333, 64, torch.bfloat16,
         False, True),
        ("d256_small", 1, 2, 1, 384, 384, 256, torch.bfloat16, True, True),
        ("sq_lt_skv", 1, 4, 2, 128, 300, 128, torch.bfloat16, True, True),
        ("sq_gt_skv", 1, 4, 2, 300, 100, 64, torch.bfloat16, True, True),
        ("f32_small", 1, 4, 2, 384, 384, 128, torch.float32, True, True),
        ("f32_ragged_d256", 1, 2, 1, 200, 200, 256, torch.float32, True,
         True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for name, b, h, hk, sq, skv, d, dt, causal, with_lse in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        # the main path's layout: [b, s, heads, d]
        q, k, v = randn(b, sq, h, d), randn(b, skv, hk, d), \
            randn(b, skv, hk, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        scale = d ** -0.5
        want, want_lse = flash_fwd_plain(qt, kt, vt, scale=scale,
                                         causal=causal, with_lse=True)
        if with_lse:
            got, got_lse = flash_fwd(qt, kt, vt, causal=causal,
                                     with_lse=True)
            lse_err = float((got_lse - want_lse).abs().max())
        else:
            got, lse_err = flash_attention(q, k, v, causal=causal) \
                .transpose(1, 2), None
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel = row_rel_err(got, want)
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash kernel {name}: non-finite output")
        if err > abs_tol[dt] or rel > row_tol[dt] or \
                (lse_err is not None and lse_err > lse_tol):
            raise AssertionError(
                f"flash kernel {name}: max err {err} (tol {abs_tol[dt]}), "
                f"row rel err {rel} (tol {row_tol[dt]}), lse err {lse_err} "
                f"(tol {lse_tol})")
        if not rows or name == "gpt2_xl_train":
            check_flash_controls(torch, name, qt, kt, vt, want, row_tol[dt])
        if with_lse:
            def kernel():
                flash_fwd(qt, kt, vt, causal=causal, with_lse=True)
        else:
            def kernel():
                flash_attention(q, k, v, causal=causal)
        # device time by graph replay; the loop of wrapper calls beside it
        # shows where the host's work per call exceeds the kernel's
        kernel_ms = cuda_graph_ms(kernel, 20)
        kernel_loop_ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(lambda: flash_fwd_plain(
            qt, kt, vt, scale=scale, causal=causal, with_lse=with_lse), 2)
        # library yardstick only; the port never calls it (at the training
        # shape with SDPA's own GQA, elsewhere on repeated kv heads)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if name == "llama3_8b_train":
            kr, vr = kt, vt
            library_ms = cuda_graph_ms(lambda: sdpa(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        else:
            kr = kt.repeat_interleave(h // hk, dim=1)
            vr = vt.repeat_interleave(h // hk, dim=1)
            library_ms = cuda_graph_ms(
                lambda: sdpa(qt, kr, vr, is_causal=causal), 20)
        bound_ms, bound_by, flops, nbytes = attention_bound(
            b, h, hk, sq, skv, d, causal, q.element_size(), with_lse, peaks)
        row = dict(case=name, shape=[b, h, hk, sq, skv, d], dtype=str(dt),
                   causal=causal, with_lse=with_lse, max_err=err,
                   tol=abs_tol[dt], row_rel_err=rel, row_rel_tol=row_tol[dt],
                   lse_err=lse_err, lse_tol=lse_tol,
                   kernel_ms=kernel_ms, kernel_loop_ms=kernel_loop_ms,
                   plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, gflop=flops / 1e9,
                   mbytes=nbytes / 1e6,
                   tflops=flops / (kernel_ms * 1e-3) / 1e12)
        emit("kernel_check", **row)
        rows[name] = row
        del q, k, v, qt, kt, vt, kr, vr, want, want_lse, got
    return rows


def dense_attention_grads(qt, kt, vt, dot, lse, delta, *, scale,
                          round_ds=None, drop_diag_from=None,
                          first_head_only=False):
    """Plain attention gradients over whole rows in float32 on the kernel
    layout, causal (top left), from the forward's lse and delta: P =
    exp(S - lse), dS = P (dP - delta) scale, no rounding of P or dS unless
    asked. Deliberately wrong variants the backward check must reject:
    ``round_ds`` rounds dS, ``drop_diag_from`` hides each row's diagonal
    64-key tile from that row on, ``first_head_only`` sums dK and dV over
    the first q head of each group only. Returns (dq, dk, dv)."""
    import torch

    b, h, s, d = qt.shape
    hk = kt.shape[1]
    n_rep = h // hk
    k = kt.repeat_interleave(n_rep, dim=1).float()
    v = vt.repeat_interleave(n_rep, dim=1).float()
    q, do = qt.float(), dot.float()
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    hide = kp > qp
    if drop_diag_from is not None:
        hide = hide | ((kp // 64 == qp // 64) & (qp >= drop_diag_from))
    p = torch.exp((q @ k.transpose(-1, -2) * scale).masked_fill(
        hide, float("-inf")) - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) * scale
    if round_ds is not None:
        ds = round_ds(ds)
    dq = (ds @ k).to(qt.dtype)
    weight = torch.ones(h, device=q.device)
    if first_head_only:
        weight = (torch.arange(h, device=q.device) % n_rep == 0).float()
    w = weight[None, :, None, None]
    dk = ((ds.transpose(-1, -2) @ q) * w).unflatten(1, (hk, n_rep)).sum(2)
    dv = ((p.transpose(-1, -2) @ do) * w).unflatten(1, (hk, n_rep)).sum(2)
    return dq, dk.to(kt.dtype), dv.to(vt.dtype)


def backward_bound(b, h, hk, s, d, itemsize, peaks, causal=True):
    """The least time for the fused backward (K2 and K3) over the (q, k)
    pairs the mask keeps on this card: its 5 products (S, dP, dV, dK, dQ)
    at the dtype's peak, or its compulsory bytes at the memory rate: q, k,
    v, out, dO and lse read once (delta = rowsum(dO * O) is computed inside
    from out and dO), dq, dk and dv written once."""
    pairs = float(np.minimum(np.arange(s) + 1, s).sum() if causal
                  else s * s)
    flops = 5 * 2.0 * b * h * d * pairs
    # q, out, dO in and dq out; k, v in and dk, dv out; lse in
    nbytes = itemsize * (4 * b * h * s * d + 4 * b * hk * s * d) \
        + 4 * b * h * s
    bf16_peak, f32_peak, mem_rate = peaks
    peak = bf16_peak if itemsize == 2 else f32_peak
    t_ops, t_bytes = flops / peak, nbytes / mem_rate
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def check_flash_bwd_controls(torch, case, qt, kt, vt, dot, lse, delta,
                             want, tol):
    """Show that the backward's tolerance tells right gradients from subtly
    wrong ones at ``case``'s shape: gradients with float32 P and dS pass
    it; dS through float8 e4m3, the diagonal kv tile missing for the later
    half of the rows, and (where a kv head has more than one q head)
    dK/dV summed over the first q head of each group only each fail it."""
    kw = dict(scale=qt.shape[-1] ** -0.5)
    variants = {
        "float32_p_and_ds": ({}, True),
        "ds_float8_e4m3": (dict(round_ds=lambda x: x.to(
            torch.float8_e4m3fn).float()), False),
        "diag_tile_dropped_late_rows": (dict(
            drop_diag_from=qt.shape[2] // 2), False),
    }
    if qt.shape[1] > kt.shape[1]:
        variants["dkv_first_q_head_only"] = (dict(first_head_only=True),
                                             False)
    errs = {}
    for name, (extra, should_pass) in variants.items():
        got = dense_attention_grads(qt, kt, vt, dot, lse, delta, **kw,
                                    **extra)
        err = max(grad_row_err(g, w) for g, w in zip(got, want))
        errs[name] = err
        del got
        if (err <= tol) != should_pass:
            raise AssertionError(
                f"backward tolerance {tol} does not separate: {name} has row "
                f"relative error {err}, should {'pass' if should_pass else 'fail'}")
    emit("flash_bwd_controls", case=case, row_rel_tol=tol, row_rel_err=errs)


def check_flash_bwd(torch, peaks):
    """Hold the fused backward (K2 and K3 in one kernel, through
    ``flash_bwd``) against K2's and K3's plain versions. At the two
    training shapes it runs the tolerance's controls and the backward a
    second time: dK and dV, summed in registers, must come out bitwise
    equal, and dQ, summed across CTAs in a float32 buffer in an order that
    changes from run to run, within the limit of the first run; then it is
    timed, as is the non-causal case (b 1, s 2048, h 32, hk 8, d 128: a
    ring step off the diagonal). Returns the timed rows by name: the main
    shape (b 2, s 2048, h 32, hk 8, d 128, bf16, causal: the shape
    Llama-3-8B's training step gives it), GPT-2 XL's (b 8, s 1024, h 25,
    hk 25, d 64) and the ring step's."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_delta, flash_bwd_dkv_plain, flash_bwd_dq_plain,
        flash_fwd)

    # Both sides round P and dS to bf16 at the same points and accumulate
    # in float32; they differ in summation order and in exp versus exp2,
    # so in bf16 rows differ by a few ulps (readings in PERF.md: row
    # errors of order 3e-3). float32: summation order only.
    # check_flash_bwd_controls shows the bf16 tolerance rejects subtly
    # wrong gradients.
    row_tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
    cases = [
        # (name, b, h, hk, s, d, dtype, causal)
        ("llama3_8b_train", 2, 32, 8, 2048, 128, torch.bfloat16, True),
        ("llama3_8b_noncausal", 1, 32, 8, 2048, 128, torch.bfloat16, False),
        ("llama3_8b_tp2", 1, 16, 4, 2048, 128, torch.bfloat16, True),
        ("d64_gqa1", 2, 8, 8, 1024, 64, torch.bfloat16, True),
        ("gpt2_xl_train", 8, 25, 25, 1024, 64, torch.bfloat16, True),
        ("d256_gqa2", 1, 4, 2, 1024, 256, torch.bfloat16, True),
        ("f32_small", 1, 4, 2, 384, 128, torch.float32, True),
        ("f32_ragged_d256", 1, 2, 1, 200, 256, torch.float32, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    timed = {}
    for name, b, h, hk, s, d, dt, causal in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        # the training step's layout: [b, s, heads, d], read through strides
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (
            randn(b, s, h, d), randn(b, s, hk, d), randn(b, s, hk, d),
            randn(b, s, h, d)))
        scale = d ** -0.5
        kw = dict(scale=scale, causal=causal)
        out, lse = flash_fwd(qt, kt, vt, causal=causal, with_lse=True)
        got = flash_bwd(qt, kt, vt, out, lse, dot, **kw)
        torch.cuda.synchronize()
        # delta as the kernel sums it (float64, rounded to float32)
        delta = flash_bwd_delta(out, dot)
        args = (qt, kt, vt, dot, lse, delta)
        want = (flash_bwd_dq_plain(*args, **kw),
                *flash_bwd_dkv_plain(*args, **kw))
        names = ("dq", "dk", "dv")
        errs = {n: grad_row_err(g, w) for n, g, w in zip(names, got, want)}
        abs_errs = {n: float((g.float() - w.float()).abs().max())
                    for n, g, w in zip(names, got, want)}
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"flash_bwd {name}: non-finite gradient")
        if max(errs.values()) > row_tol[dt]:
            raise AssertionError(
                f"flash_bwd {name}: row rel err {errs} (tol {row_tol[dt]})")
        with_controls = name in ("llama3_8b_train", "gpt2_xl_train")
        is_timed = with_controls or name in ("llama3_8b_noncausal",
                                             "llama3_8b_tp2")
        if with_controls:
            check_flash_bwd_controls(torch, name, qt, kt, vt, dot, lse,
                                     delta, want, row_tol[dt])
        row = dict(case=name, shape=[b, h, hk, s, s, d], dtype=str(dt),
                   causal=causal, row_rel_err=errs, row_rel_tol=row_tol[dt],
                   max_abs_err=abs_errs)
        if with_controls:
            again = flash_bwd(qt, kt, vt, out, lse, dot, **kw)
            torch.cuda.synchronize()
            row["dkv_bitwise_equal_across_runs"] = bool(
                torch.equal(again[1], got[1]) and
                torch.equal(again[2], got[2]))
            row["dq_run_to_run_row_err"] = grad_row_err(again[0], got[0])
            if not row["dkv_bitwise_equal_across_runs"] or \
                    row["dq_run_to_run_row_err"] > row_tol[dt]:
                raise AssertionError(
                    f"flash_bwd {name} run twice: dK/dV bitwise equal "
                    f"{row['dkv_bitwise_equal_across_runs']}, dQ row "
                    f"difference {row['dq_run_to_run_row_err']} (tol "
                    f"{row_tol[dt]})")
            del again
        if is_timed:
            # timed at the training shapes and a ring step's only (the others are checks): by
            # graph replay, and the loop of wrapper calls beside it
            def kernel():
                flash_bwd(qt, kt, vt, out, lse, dot, **kw)

            def plain():
                dl = flash_bwd_delta(out, dot)
                flash_bwd_dq_plain(qt, kt, vt, dot, lse, dl, **kw)
                flash_bwd_dkv_plain(qt, kt, vt, dot, lse, dl, **kw)
            row["kernel_ms"] = cuda_graph_ms(kernel, 10)
            row["kernel_loop_ms"] = cuda_ms(kernel, 10)
            row["plain_ms"] = cuda_ms(plain, 1)
            # library yardstick only (the port never calls it): SDPA's
            # backward with GQA, as forward + backward minus forward, both
            # by graph replay
            q, k, v = (x.detach().requires_grad_() for x in (qt, kt, vt))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (q, k, v), dot)
            with torch.no_grad():
                fwd_ms = cuda_graph_ms(sdpa, 10)
            row["library_ms"] = cuda_graph_ms(sdpa_fwd_bwd, 10) - fwd_ms
            row["library_fwd_ms"] = fwd_ms
            bound_ms, bound_by, flops, nbytes = backward_bound(
                b, h, hk, s, d, qt.element_size(), peaks, causal)
            row.update(bound_ms=bound_ms, bound_by=bound_by,
                       gflop=flops / 1e9, mbytes=nbytes / 1e6,
                       tflops=flops / (row["kernel_ms"] * 1e-3) / 1e12)
            timed[name] = row
            del q, k, v
        emit("flash_bwd_check", **row)
        del qt, kt, vt, dot, out, lse, delta, args, got, want
    return timed


def fp8_rounded_attention(q, k, v, **kwargs):
    """Reference attention with q, k and v rounded through float8 e4m3:
    attention in a lower precision than bf16 inputs, to show that the
    forward tolerance would catch it."""
    import torch
    from ray_tpu_torch.ops.attention import reference_attention

    def r(x):
        return x.to(torch.float8_e4m3fn).to(x.dtype)
    return reference_attention(r(q), r(k), r(v),
                               causal=kwargs.get("causal", True))


def forward_against_reference(torch, forward, module, ctx=None):
    """``forward(attn_impl)`` (logits) through the flash kernel, timed with
    the launches counted, against the same forward with reference
    attention, and a control: the forward with attention fed
    float8-rounded inputs (``module.attention`` patched), what a lower
    precision than bf16-in / f32-accumulate does to the same logits.
    ``ctx(role)`` (role: "flash", "reference" or "control") gives a
    context each run goes in. Returns (logits, reference logits, a
    dictionary of the errors, the launch counts, the seconds of each
    forward)."""
    ctx = ctx or (lambda role: contextlib.nullcontext())
    forward("auto")                       # warm-up, not counted
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with ctx("flash"):
        logits = forward("auto")
        torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    counts = launch_counts()
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    t0 = time.perf_counter()
    with ctx("reference"):
        ref = forward("reference")
        torch.cuda.synchronize()
    reference_s = time.perf_counter() - t0
    orig = module.attention
    module.attention = fp8_rounded_attention
    try:
        with ctx("control"):
            low = forward("auto")
    finally:
        module.attention = orig
    errs = {"logits_rel_rms_err": rel_rms(logits, ref),
            "fp8_attention_rel_rms_err": rel_rms(low, ref),
            "argmax_agreement": float(
                (logits.argmax(-1) == ref.argmax(-1)).float().mean()),
            "max_abs_err": float((logits - ref).abs().max())}
    del low
    return logits, ref, errs, counts, (forward_s, reference_s)


def hold_forward(name, errs, tol):
    """Raise unless the flash forward's logits are within ``tol`` of the
    reference forward's and the float8 control is not."""
    err = errs["logits_rel_rms_err"]
    err_low = errs["fp8_attention_rel_rms_err"]
    if not err <= tol < err_low:
        raise AssertionError(
            f"{name}: forward logits rel err {err} vs tol {tol} (float8 "
            f"attention gives {err_low}; the tolerance must sit between)")


def check_model(torch, cfg, params) -> int:
    """The full forward through the flash kernel against the same forward
    with reference attention. Returns the flash kernel's launches in the
    timed forward, read right after it."""
    from ray_tpu_torch.models import llama

    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 2048)).astype(np.int64)).cuda()
    logits, _, errs, counts, (forward_s, reference_s) = \
        forward_against_reference(torch, lambda impl: llama.forward(
            cfg, params, tokens, attn_impl=impl), llama)
    launches = counts["flash_fwd"]
    if launches != cfg.n_layers:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"one forward, expected {cfg.n_layers}")
    if logits.shape != (1, 2048, cfg.vocab_size):
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    # Both forwards are bf16 models that differ only in attention's
    # rounding points (the kernel rounds unnormalized probabilities to
    # bf16, the reference normalized ones); over 32 layers that leaves a
    # relative RMS logit error of order 1e-2. The tolerance sits below the
    # float8 variant's error, so a lower-precision attention fails it.
    tol = 5e-2
    emit("model", config="llama3_8b", n_layers=cfg.n_layers, seq=2048,
         flash_launches=launches, forward_s=forward_s,
         reference_forward_s=reference_s, tol=tol, **errs)
    hold_forward("llama3_8b", errs, tol)
    return launches


def check_lm_head(torch, cfg, params):
    """The LM head's float32 logits from bf16 operands against a float32
    product of the same operands. Logits rounded to bf16 on the way (a
    relative error of order 1e-3) fail the tolerance; float32 products
    that differ only in summation order (order 1e-6) pass it."""
    from ray_tpu_torch.models import llama

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((256, cfg.d_model), generator=gen, device="cuda") \
        .to(cfg.param_dtype)
    head = llama.lm_head_weights(cfg, params)
    got = llama.matmul_f32(x, head)
    want = x.float() @ head.float()
    tol = 1e-4
    err = rel_rms(got, want)
    err_bf16 = rel_rms((x @ head).float(), want)
    emit("lm_head", rows=256, vocab=cfg.vocab_size, dtype=str(got.dtype),
         logits_rel_rms_err=err, tol=tol,
         bf16_rounded_logits_rel_rms_err=err_bf16)
    if got.dtype != torch.float32 or not err <= tol < err_bf16:
        raise AssertionError(
            f"LM head logits {got.dtype} rel err {err} vs tol {tol} "
            f"(bf16-rounded logits give {err_bf16}; the tolerance must sit "
            "between)")


def check_serve(torch, cfg, params):
    """PagedLLMEngine at full width: 8 greedy requests plus two that share
    a 512-token prefix; then one request's paged prefill and decode
    logits against the full forward."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_fwd
    from ray_tpu_torch.serve.paged_llm import (PagedLLMEngine,
                                               paged_decode_logits,
                                               paged_prefill_logits)

    rng = np.random.default_rng(SEED + 1)
    new_tokens = 32
    prompts = [rng.integers(1, cfg.vocab_size, 128) for _ in range(8)]
    shared = rng.integers(1, cfg.vocab_size, 512)
    tails = [rng.integers(1, cfg.vocab_size, 40) for _ in range(2)]
    eng = PagedLLMEngine(cfg, params, max_batch=8, max_len=2048,
                         page_size=128, decode_chunk=16)
    eng.warmup(128)
    eng.warmup_prefix(512, 40, max_n=1)
    flash_fwd.launches = 0
    t0 = time.perf_counter()
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    reqs.append(eng.submit(np.concatenate([shared, tails[0]]),
                           max_new_tokens=new_tokens))
    outs = [list(r.tokens()) for r in reqs]
    # the second shared-prefix request arrives once the first has
    # registered its prefix pages
    late = eng.submit(np.concatenate([shared, tails[1]]),
                      max_new_tokens=new_tokens)
    outs.append(list(late.tokens()))
    reqs.append(late)
    wall = time.perf_counter() - t0
    st = eng.stats()
    eng.stop()
    # the engines' attention is the JAX package's einsum code, not K1
    serve_launches = flash_fwd.launches
    if eng.error is not None:
        raise eng.error
    if any(len(o) != new_tokens for o in outs):
        raise AssertionError(f"token counts {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("token id out of range")
    hits = st["prefix_cache"]["hit_pages"]
    if hits <= 0:
        raise AssertionError(f"prefix cache never hit: {st}")
    ttfts = [r.ttft for r in reqs]
    emit("serve", config="llama3_8b", n_layers=cfg.n_layers, max_batch=8,
         max_len=2048, page_size=128, decode_chunk=16,
         requests=len(outs), new_tokens_each=new_tokens,
         flash_launches=serve_launches,
         p50_ttft_s=float(np.median(ttfts)), max_ttft_s=float(max(ttfts)),
         tokens_per_s=sum(map(len, outs)) / wall, wall_s=wall,
         prefix_hit_pages=hits, kv_pages_bytes=st["kv_pages_bytes"],
         kv_dense_equiv_bytes=st["kv_dense_equiv_bytes"],
         ttft_breakdown_s=st.get("ttft_breakdown_s"))

    # paged programs against the full forward (reference attention) over
    # the same tokens: request 0's prompt, then 4 of its decode steps
    prompt, out = prompts[0], outs[0]
    dev = torch.device("cuda")
    pools = tuple(torch.zeros_like(x[:, :3]) for x in
                  (eng._k_pages, eng._v_pages)) + \
        (eng._k_scale, eng._v_scale)   # 2 pages + the sink
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    seq = torch.tensor(np.concatenate([prompt, out[:4]]), device=dev)[None]
    got = [paged_prefill_logits(
        cfg, params, pools, table, seq[:, :128].int(),
        torch.tensor([128], dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev), quantized=False)[0]]
    for j in range(4):
        got.append(paged_decode_logits(
            cfg, params, pools, table, seq[:, 128 + j].int(),
            torch.tensor([128 + j], dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev),
            quantized=False)[0])
    ref = llama.forward(cfg, params, seq, attn_impl="reference")[0]
    # bf16 model: the paged programs multiply other matrix shapes than the
    # full forward (one row per decode step), so bf16 GEMM outputs round
    # differently; attention itself follows the same recipe
    tol = 5e-2
    errs = [rel_rms(g, ref[127 + j]) for j, g in enumerate(got)]
    emit("paged_vs_forward", steps=["prefill", "decode1", "decode2",
                                    "decode3", "decode4"],
         logits_rel_rms_err=errs, tol=tol,
         argmax_agree=[int(g.argmax()) == int(ref[127 + j].argmax())
                       for j, g in enumerate(got)])
    if max(errs) > tol:
        raise AssertionError(f"paged logits rel err {errs} > tol {tol}")


def launch_counts():
    from ray_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    return {"flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches}


def zero_counts():
    from ray_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    flash_fwd.launches = flash_bwd.launches = 0


def named_leaves(tree, prefix=""):
    """(dotted name, tensor) of a nested dictionary, in the order of
    ``train.optim.tree_leaves``."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in named_leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def train_batch(cfg, b: int, s: int, seed: int):
    """A [b, s + 1] int64 token batch on the card, from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int64)).cuda()


def first_layers(params, depth: int) -> dict:
    """The first ``depth`` layers of a stacked parameter tree, as detached
    leaves that share the full model's storage."""
    return {k: ({n: w[:depth].detach() for n, w in v.items()}
                if k == "blocks" else v.detach())
            for k, v in params.items()}


def grads_against_reference(torch, params, loss, module, want_counts,
                            ctx=None, attr="attention", **fields):
    """The gradient of ``loss(attn_impl)`` in every leaf of ``params``
    through the flash kernels (K1 with lse, the fused backward) against
    the same gradient through reference attention. The control: the same
    loss with q detached before attention (``module.<attr>`` patched: the
    fault of a forward with no gradient) must fail the tolerance.
    ``ctx(role)`` (role: "flash", "reference" or "control") gives a
    context each loss and its backward go in. Emits the "grad" line with
    ``fields``; returns the launch counts and the flash path's gradients
    by leaf name."""
    ctx = ctx or (lambda role: contextlib.nullcontext())
    names, leaves = zip(*named_leaves(params))
    for t in leaves:
        t.requires_grad_(True)

    def grads(attn_impl, role):
        with ctx(role):
            value = loss(attn_impl)
            # the detached-q control leaves wq without a gradient: zeros
            return value, torch.autograd.grad(
                value, leaves, allow_unused=True, materialize_grads=True)

    zero_counts()
    value, got = grads("auto", "flash")
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != want_counts:
        raise AssertionError(f"launches in one gradient {counts}, expected "
                             f"{want_counts}")
    ref_value, want = grads("reference", "reference")
    # bf16 model: the two attentions round at other points (the kernels
    # round P and dS to bf16, the reference its normalized probabilities),
    # and that reaches every gradient through the residual stream
    tol = 5e-2
    errs = {n: rel_rms(g, w) for n, g, w in zip(names, got, want)}
    orig = getattr(module, attr)
    setattr(module, attr,
            lambda q, k, v, **kw: orig(q.detach(), k, v, **kw))
    try:
        _, bad = grads("auto", "control")
    finally:
        setattr(module, attr, orig)
    bad_errs = {n: rel_rms(g, w) for n, g, w in zip(names, bad, want)}
    del bad, want
    emit("grad", **fields, loss=float(value.detach()),
         reference_loss=float(ref_value.detach()), launches=counts,
         rel_rms_err=errs, tol=tol, q_detached_rel_rms_err=bad_errs)
    if max(errs.values()) > tol or max(bad_errs.values()) <= tol:
        raise AssertionError(
            f"gradient rel err {errs} vs tol {tol}; the detached-q control "
            f"must exceed it: {bad_errs}")
    for t in leaves:
        t.requires_grad_(False)
    return counts, dict(zip(names, got))


def check_grad(torch, cfg, params):
    """The gradient of the training loss through the flash kernels
    against reference attention (``grads_against_reference``), at full
    width and depth 2, on [2, 2049] tokens."""
    import dataclasses

    from ray_tpu_torch.models import llama

    depth = 2
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    params2 = first_layers(params, depth)
    batch = train_batch(cfg, 2, 2048, SEED + 3)

    def loss(attn_impl):
        hidden = llama.forward_hidden(cfg2, params2, batch[:, :-1],
                                      attn_impl=attn_impl)
        return llama.fused_cross_entropy(cfg2, params2, hidden, batch[:, 1:],
                                         chunk=1024)

    # remat "full": K1 reruns in the backward
    grads_against_reference(
        torch, params2, loss, llama,
        {"flash_fwd": 2 * depth, "flash_bwd": depth}, config="llama3_8b",
        n_layers=depth, tokens=[2, 2049])


def free_card(torch):
    """Return the card's memory of the previous phase's model."""
    gc.collect()
    torch.cuda.empty_cache()


def step_flops(n_matmul, b, s, n_layers, n_heads, head_dim) -> float:
    """A causal LM training step's FLOPs: 6 N T for the N matmul
    parameters over T tokens, plus attention's 12 L b h hd (q, k) pairs
    under the causal mask; no recompute."""
    pairs = s * (s + 1) // 2
    return 6.0 * n_matmul * b * s + 12.0 * n_layers * b * n_heads * \
        head_dim * pairs


def check_losses(name, losses, vocab_size):
    """Training losses finite, the first within 1.0 of ln(vocab) (random
    weights), the last below the second (the first step's learning rate
    is 0 under the warmup)."""
    first_ok = abs(losses[0] - float(np.log(vocab_size))) < 1.0
    if not (all(np.isfinite(losses)) and first_ok
            and losses[-1] < losses[1]):
        raise AssertionError(f"{name} training losses {losses} (first "
                             f"should be near ln(vocab) "
                             f"{np.log(vocab_size):.2f} and the last below "
                             "the second)")


def check_train(torch, cfg, params, peaks):
    """The trainer on llama3_8b() at full width and depth, bf16, with the
    fused loss: 6 steps on one repeated [2, 2049] batch, then one step
    under remat "attn". Returns the launch counts of one step under each
    policy and the 6 losses."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    b, s, steps = 2, 2048, 6
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainConfig(fused_loss=True, loss_chunk=1024,
                                       warmup_steps=1))
    state = TrainState.create(params, trainer.optimizer)
    # parameters, gradients and the two moments, all in the params' dtype
    state_bytes = 4 * sum(t.numel() * t.element_size()
                          for _, t in named_leaves(params))
    batch = train_batch(cfg, b, s, SEED + 4)
    losses, times, norms = [], [], []
    for i in range(steps):
        if i == steps - 1:
            zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))   # synchronizes
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    full_counts = launch_counts()
    trainer.model_cfg = dataclasses.replace(cfg, remat="attn")
    zero_counts()
    state, m = trainer.train_step(state, batch)
    attn_loss = float(m["loss"])
    attn_counts = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want_full = {"flash_fwd": 2 * L, "flash_bwd": L}
    want_attn = {"flash_fwd": L, "flash_bwd": L}
    step_s = float(np.median(times[1:]))
    # matmul parameters: the blocks' seven matrices and the LM head
    n_matmul = sum(params["blocks"][k].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + llama.lm_head_weights(cfg, params).numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    emit("train", config="llama3_8b", n_layers=L, depth_cut=None,
         tokens=[b, s + 1], remat=cfg.remat, fused_loss=True,
         loss_chunk=1024, steps=steps, losses=losses, grad_norms=norms,
         step_s=times, median_step_s=step_s, tokens_per_s=b * s / step_s,
         flops_per_step=flops, mfu=flops / step_s / peaks[0],
         peak_memory_bytes=peak_bytes, state_bytes=state_bytes,
         launches_full=full_counts, launches_attn=attn_counts,
         attn_step_loss=attn_loss)
    check_losses("llama3_8b", losses + [attn_loss], cfg.vocab_size)
    if full_counts != want_full or attn_counts != want_attn:
        raise AssertionError(
            f"launches in one step: full {full_counts} (want {want_full}), "
            f"attn {attn_counts} (want {want_attn})")
    return full_counts, attn_counts, losses


# ---------------------------------------------------------------------------
# Sequence parallelism (ring and Ulysses attention) and speculative
# decoding at Llama-3-8B's widths: every rank of the sp axis on this card
# ---------------------------------------------------------------------------

RING_SP = 4
# (b, s, h, hk, d): Llama-3-8B's heads over its published 8K context, and
# the Ulysses check's half of it
RING_SHAPE = (1, 8192, 32, 8, 128)
ULYSSES_SHAPE = (1, 4096, 32, 8, 128)
# speculative decoding: right-padded prompt lengths, new tokens, k
SPEC_PROMPT_LENS = (17, 83, 149, 200)
SPEC_NEW_TOKENS = 64
SPEC_K = 4


def sp_mesh(torch):
    """An sp mesh of RING_SP ranks, every one on this card."""
    from ray_tpu_torch.parallel.mesh import create_mesh

    card = torch.device("cuda", torch.cuda.current_device())
    return create_mesh({"sp": RING_SP}, devices=[card] * RING_SP)


def ring_walk(torch, qt, kt, vt, dot, *, causal, fault=None,
              backward=False):
    """The flash ring spelled out step by step for the controls, on
    kernel-layout global tensors [b, h|hk, s, d] over RING_SP ranks: K1
    with lse on each live step, the log-sum-exp merge, then (with
    ``backward``) flash_bwd on each live step with the final output and the
    merged lse. ``fault`` makes it subtly wrong: "merge_without_lse_rescale"
    (the partial outputs averaged), "off_diagonal_causal" (the steps off
    the diagonal masked causal), "own_step_lse" (the backward fed each
    step's own lse). Unfaulted it runs the kernels of
    ``parallel.ring_attention``'s flash ring on the same inputs in the same
    order. Returns (out, (dq, dk, dv) or None)."""
    from ray_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from ray_tpu_torch.parallel.ring_attention import _merge

    n = RING_SP
    qs, ks, vs, dos = (x.chunk(n, dim=2) for x in (qt, kt, vt, dot))
    scale = qt.shape[-1] ** -0.5
    live = [(r, idx) for r in range(n) for idx in range(n)
            if not (causal and r > 0 and idx < r)]

    def step_causal(r):
        return (causal and r == 0) or (fault == "off_diagonal_causal"
                                       and r > 0)
    outs, lses, own = [None] * n, [None] * n, {}
    for r, idx in live:
        src = (idx - r) % n
        o, lse = flash_fwd(qs[idx], ks[src], vs[src], scale=scale,
                           causal=step_causal(r), with_lse=True)
        own[r, idx] = lse
        if r == 0:
            outs[idx], lses[idx] = o.float(), lse
        elif fault == "merge_without_lse_rescale":
            outs[idx] = (outs[idx] + o.float()) / 2
            lses[idx] = torch.logaddexp(lses[idx], lse)
        else:
            outs[idx], lses[idx] = _merge(outs[idx], lses[idx], o.float(),
                                          lse)
    out = torch.cat([o.to(qt.dtype) for o in outs], dim=2)
    if not backward:
        return out, None
    outc = out.chunk(n, dim=2)
    dq, dk, dv = [0.0] * n, [0.0] * n, [0.0] * n
    for r, idx in live:
        src = (idx - r) % n
        lse = own[r, idx] if fault == "own_step_lse" else lses[idx]
        g = flash_bwd(qs[idx], ks[src], vs[src], outc[idx], lse, dos[idx],
                      scale=scale, causal=step_causal(r))
        dq[idx] = dq[idx] + g[0].float()
        dk[src] = dk[src] + g[1].float()
        dv[src] = dv[src] + g[2].float()
    return out, tuple(torch.cat(x, dim=2).to(qt.dtype) for x in (dq, dk, dv))


def check_ring_kernels(torch, peaks) -> dict:
    """``ring_attention(impl="flash")`` at Llama-3-8B's heads (h 32, hk 8,
    d 128) over s 8192 on an sp-4 mesh of this card (chunks of 2048), bf16,
    causal and not: its launches, exact per call (K1 and the fused backward
    10 times each causal, 16 not); its output and the gradients of a
    random cotangent against the whole-sequence flash kernels; the limits'
    controls; times by CUDA-graph replay beside the whole-sequence kernels
    and SDPA. Returns the launch counts of one forward and backward by
    mode."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    mesh = sp_mesh(torch)
    b, s, h, hk, d = RING_SHAPE
    # The ring rounds each step's output to bf16 before its float32 merge
    # and sums the steps' bf16 dq, dk and dv in float32, where the whole-
    # sequence kernels keep one float32 accumulator: a few more bf16
    # roundings a row. The limits are K1's row limit for the output and
    # twice it for the gradients; each fault below must fail them.
    out_tol, grad_tol = 1e-2, 2e-2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    counts_by_mode = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for causal in (True, False):
        mode = "causal" if causal else "noncausal"
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for shape in (
                           (b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                           (b, s, h, d)))
        leaves = tuple(x.requires_grad_() for x in (q, k, v))

        def ring():
            return ring_attention(q, k, v, mesh=mesh, causal=causal,
                                  impl="flash")

        def whole():
            return flash_attention(q, k, v, causal=causal)

        zero_counts()
        out = ring()
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        counts = launch_counts()
        out = out.detach()
        live = RING_SP * (RING_SP + 1) // 2 if causal else RING_SP ** 2
        want_counts = {"flash_fwd": live, "flash_bwd": live}
        want = whole()
        want_grads = torch.autograd.grad(want, leaves, do)
        want = want.detach()
        out_err = row_rel_err(out, want)
        grad_errs = {f"d{n}": grad_row_err(g, w)
                     for n, g, w in zip("qkv", grads, want_grads)}
        finite = bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(g).all()) for g in grads)

        # the controls, on the kernel layout
        qt, kt, vt, dot = (x.detach().transpose(1, 2) for x in (q, k, v, do))
        walk, _ = ring_walk(torch, qt, kt, vt, dot, causal=causal)
        walk_equal = bool(torch.equal(walk, out.transpose(1, 2)))
        walk_err = row_rel_err(walk, out.transpose(1, 2))
        want_t = want.transpose(1, 2)
        controls = {}
        for fault in ("merge_without_lse_rescale", "off_diagonal_causal"):
            bad, _ = ring_walk(torch, qt, kt, vt, dot, causal=causal,
                               fault=fault)
            controls[fault] = row_rel_err(bad, want_t)
        _, bad = ring_walk(torch, qt, kt, vt, dot, causal=causal,
                           fault="own_step_lse", backward=True)
        controls["own_step_lse"] = max(
            grad_row_err(g, w.transpose(1, 2))
            for g, w in zip(bad, want_grads))
        del walk, bad

        # timed on fresh leaves: the autograd graphs above hold the
        # leaves' gradient accumulators on the default stream, which a
        # capture on a side stream may not touch
        tq, tk, tv = (x.detach().requires_grad_() for x in (q, k, v))
        fresh = (tq, tk, tv)

        def ring_t():
            return ring_attention(tq, tk, tv, mesh=mesh, causal=causal,
                                  impl="flash")

        def whole_t():
            return flash_attention(tq, tk, tv, causal=causal)

        def sdpa_t():
            return sdpa(tq.transpose(1, 2), tk.transpose(1, 2),
                        tv.transpose(1, 2), is_causal=causal,
                        enable_gqa=True)

        def ring_fwd_bwd():
            torch.autograd.grad(ring_t(), fresh, do)

        def whole_fwd_bwd():
            torch.autograd.grad(whole_t(), fresh, do)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_t(), fresh, do.transpose(1, 2))
        with torch.no_grad():
            ring_fwd_ms = cuda_graph_ms(ring_t, 5)
            whole_fwd_ms = cuda_graph_ms(whole_t, 5)
            sdpa_fwd_ms = cuda_graph_ms(sdpa_t, 5)
        ring_ms = cuda_graph_ms(ring_fwd_bwd, 5)
        whole_ms = cuda_graph_ms(whole_fwd_bwd, 5)
        sdpa_ms = cuda_graph_ms(sdpa_fwd_bwd, 5)
        fwd_bound = attention_bound(b, h, hk, s, s, d, causal, 2, True,
                                    peaks)
        bwd_bound = backward_bound(b, h, hk, s, d, 2, peaks, causal)
        emit("ring_kernels", mode=mode, shape=[b, h, hk, s, d], sp=RING_SP,
             chunk=s // RING_SP, dtype="torch.bfloat16", launches=counts,
             want_launches=want_counts, out_row_rel_err=out_err,
             out_tol=out_tol, grad_row_rel_err=grad_errs, grad_tol=grad_tol,
             controls=controls, walk_equals_ring_bitwise=walk_equal,
             walk_row_rel_err=walk_err,
             ring_fwd_ms=ring_fwd_ms, whole_fwd_ms=whole_fwd_ms,
             library_fwd_ms=sdpa_fwd_ms, ring_fwd_bwd_ms=ring_ms,
             whole_fwd_bwd_ms=whole_ms, library_fwd_bwd_ms=sdpa_ms,
             bound_fwd_ms=fwd_bound[0], bound_fwd_bwd_ms=fwd_bound[0]
             + bwd_bound[0], bound_by=[fwd_bound[1], bwd_bound[1]])
        fwd_faults = ("merge_without_lse_rescale", "off_diagonal_causal")
        # the unfaulted walk is the ring itself (K1 is deterministic, so
        # on the card the two agree bit for bit)
        if counts != want_counts or not finite or walk_err > out_tol / 10 \
                or out_err > out_tol \
                or max(grad_errs.values()) > grad_tol \
                or min(controls[f] for f in fwd_faults) <= out_tol \
                or controls["own_step_lse"] <= grad_tol:
            raise AssertionError(
                f"ring attention {mode}: launches {counts} (want "
                f"{want_counts}), finite {finite}, the walk's row err from "
                f"the ring {walk_err}, out err {out_err} (tol {out_tol}), grad "
                f"errs {grad_errs} (tol {grad_tol}); every control must "
                f"fail its limit: {controls}")
        counts_by_mode[mode] = counts
        del q, k, v, do, out, grads, want, want_grads, qt, kt, vt, dot
        del tq, tk, tv, fresh
    return counts_by_mode


def check_ulysses(torch):
    """``ulysses_attention_sharded`` at Llama-3-8B's heads (h 32, hk 8, d
    128) over s 4096 on an sp-4 mesh of this card, bf16, causal, against
    ``reference_attention`` over the whole sequence. Both run the same
    float32 attention on the same heads; the all-to-alls only move
    data. The control: the output with its sequence chunks in a rotated
    rank order (an all-to-all that joins ranks in the wrong order) must
    fail the limit."""
    from ray_tpu_torch.ops.attention import reference_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    mesh = sp_mesh(torch)
    b, s, h, hk, d = ULYSSES_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ulysses_attention_sharded(mesh, q, k, v, causal=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = reference_attention(q, k, v, causal=True)
    tol = 1e-2
    err = row_rel_err(got, want)
    control = row_rel_err(got.roll(s // RING_SP, dims=1), want)
    emit("ulysses", shape=[b, h, hk, s, d], sp=RING_SP, dtype=str(q.dtype),
         row_rel_err=err, max_abs_err=float((got.float()
                                             - want.float()).abs().max()),
         tol=tol, rotated_ranks_row_rel_err=control, seconds=seconds)
    if not (bool(torch.isfinite(got).all()) and err <= tol < control):
        raise AssertionError(f"Ulysses row err {err} vs tol {tol} (the "
                             f"rotated-rank control gives {control})")


def check_ring_grad(torch, cfg, params, mesh):
    """The gradient of the training loss through the ring (sp 4 on this
    card) against the whole-sequence flash path, at full width and depth
    2, on [1, 8193] tokens, with the detached-q control
    (``grads_against_reference`` on ``llama.ring_attention``)."""
    import dataclasses

    from ray_tpu_torch.models import llama

    depth = 2
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    params2 = first_layers(params, depth)
    s = RING_SHAPE[1]
    batch = train_batch(cfg, 1, s, SEED + 7)

    def loss(attn_impl):
        # "auto" is the path under test here: the ring; "reference" its
        # yardstick: the whole-sequence flash kernels
        impl = "ring" if attn_impl == "auto" else "auto"
        hidden = llama.forward_hidden(cfg2, params2, batch[:, :-1],
                                      attn_impl=impl, mesh=mesh)
        return llama.fused_cross_entropy(cfg2, params2, hidden, batch[:, 1:],
                                         chunk=1024)

    # remat "full": the ring's forward reruns in the backward
    live = RING_SP * (RING_SP + 1) // 2
    counts, _ = grads_against_reference(
        torch, params2, loss, llama,
        {"flash_fwd": 2 * depth * live, "flash_bwd": depth * live},
        attr="ring_attention", config="llama3_8b", n_layers=depth,
        tokens=[1, s + 1], path="ring_sp4", against="whole_sequence_flash")
    return counts


def check_ring_train(torch, cfg, params, peaks, mesh):
    """The trainer's ring path on llama3_8b() at full width and depth:
    ``Trainer(..., TrainConfig(mesh_axes={"sp": 4},
    strategy="fsdp_tp_sp", fused_loss=True), mesh=mesh)`` on one [1, 8193]
    batch (Llama 3's 8K context) under remat "full", three steps. Returns
    the launch counts of the last step."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    b, s, steps = 1, RING_SHAPE[1], 3
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainConfig(mesh_axes={"sp": RING_SP},
                                       strategy="fsdp_tp_sp", fused_loss=True,
                                       loss_chunk=1024, warmup_steps=1),
                      mesh=mesh)
    if trainer.attn_impl != "ring":
        raise AssertionError(f"sp trainer took attn_impl "
                             f"{trainer.attn_impl!r}, not the ring")
    state = TrainState.create(params, trainer.optimizer)
    batch = train_batch(cfg, b, s, SEED + 8)
    losses, times, norms, counts = [], [], [], []
    for _ in range(steps):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))   # synchronizes
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        counts.append(launch_counts())
    peak_bytes = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    live = RING_SP * (RING_SP + 1) // 2
    want = {"flash_fwd": 2 * L * live, "flash_bwd": L * live}
    step_s = float(np.median(times[1:]))
    n_matmul = sum(params["blocks"][k].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + llama.lm_head_weights(cfg, params).numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    emit("ring_train", config="llama3_8b", n_layers=L, depth_cut=None,
         tokens=[b, s + 1], mesh={"sp": RING_SP}, strategy="fsdp_tp_sp",
         attn_impl=trainer.attn_impl, remat=cfg.remat, fused_loss=True,
         steps=steps, losses=losses, grad_norms=norms, step_s=times,
         median_step_s=step_s, tokens_per_s=b * s / step_s,
         flops_per_step=flops, mfu=flops / step_s / peaks[0],
         peak_memory_bytes=peak_bytes, launches=counts, want_launches=want)
    check_losses("llama3_8b ring", losses, cfg.vocab_size)
    if any(c != want for c in counts):
        raise AssertionError(f"ring trainer launches per step {counts}, "
                             f"want {want}")
    return counts[-1]


def check_speculative(torch, cfg, params) -> dict:
    """``speculative_generate`` with llama3_8b() at full depth as the
    target, against its greedy ``decoding.generate``: 4 right-padded
    prompts of 17-200 tokens, k_spec 4, 64 new tokens, with two drafts:
    the target itself (which accepts every proposal a near-tie does not
    flip) and a depth-2 model at the same widths from another seed.

    On the card the verify forward multiplies b (k+1) rows where the
    decode step multiplies b, and cuBLAS may sum those products in other
    orders, so a bf16 greedy token at a near-tie can differ through no
    fault of the drafting. So tokens are held equal up to each row's first
    divergence, and at that position (or, for a row with none, at
    position 32) the verify's logit row is held within a bf16 bound of
    the decode's, with a control that must fail it: the verify's row one
    position off. At a divergence the decode's top-two gap must lie under
    the two rows' difference at the two tokens. Returns the launch counts
    of the speculative runs (the serve path runs no kernel)."""
    import dataclasses

    from ray_tpu_torch.models import decoding, llama, speculative

    lens = list(SPEC_PROMPT_LENS)
    b, k_spec, n_new = len(lens), SPEC_K, SPEC_NEW_TOKENS
    rng = np.random.default_rng(SEED + 9)
    prompts = np.zeros((b, max(lens)), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(1, cfg.vocab_size, n)
    prompts = torch.from_numpy(prompts).cuda()
    draft_cfg = dataclasses.replace(cfg, n_layers=2)
    draft_params = llama.init_params(draft_cfg, seed=SEED + 10,
                                     device="cuda")
    greedy = decoding.SamplingParams(temperature=0.0, max_new_tokens=n_new)
    # Both forwards are bf16 models that differ only in GEMM summation
    # order; the limit is the full forward's against reference attention
    tol = 5e-2

    # warm-up of both paths (cuBLAS heuristics, first launches)
    decoding.generate(cfg, params, prompts[:, :32],
                      sampling=decoding.SamplingParams(temperature=0.0,
                                                       max_new_tokens=2))
    speculative.speculative_generate(cfg, params, draft_cfg, draft_params,
                                     prompts[:, :32], k_spec=k_spec,
                                     max_new_tokens=2)

    decode_logits = []
    orig_decode = decoding.cached_forward

    def record_decode(*args, **kw):
        logits, cache = orig_decode(*args, **kw)
        decode_logits.append(logits)
        return logits, cache
    decoding.cached_forward = record_decode
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = decoding.generate(cfg, params, prompts, sampling=greedy)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    finally:
        decoding.cached_forward = orig_decode

    counts = {}
    for name, d_cfg, d_params in (("self", cfg, params),
                                  ("depth2", draft_cfg, draft_params)):
        verify = []
        orig_verify = speculative.cached_forward

        def record_verify(*args, **kw):
            logits, cache = orig_verify(*args, **kw)
            if kw.get("logits_mode") == "all":   # the target's verify
                verify.append((kw["start"], logits))
            return logits, cache
        speculative.cached_forward = record_verify
        zero_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, stats = speculative.speculative_generate(
                cfg, params, d_cfg, d_params, prompts, k_spec=k_spec,
                max_new_tokens=n_new, return_stats=True)
            torch.cuda.synchronize()
            spec_s = time.perf_counter() - t0
        finally:
            speculative.cached_forward = orig_verify
        counts[name] = launch_counts()
        starts = torch.stack([st for st, _ in verify]).cpu()   # [rounds, B]
        rows = []
        for r in range(b):
            diff = (got[r] != want[r]).nonzero()
            first = int(diff[0]) if len(diff) else None
            j = first if first is not None else n_new // 2
            if j == 0:
                raise AssertionError(f"speculative {name}: row {r} differs "
                                     "at the prefill token")
            pos = lens[r] + j - 1    # the position whose logits give out[j]
            c = int((starts[:, r] <= pos).nonzero().max())
            i = pos - int(starts[c, r])
            logits = verify[c][1][r]
            dec, ver = decode_logits[j][r], logits[i]
            shifted = logits[i + 1 if i < k_spec else i - 1]
            row = {"row": r, "prompt_len": lens[r], "first_divergence": first,
                   "held_at": j, "logits_rel_rms_err": rel_rms(ver, dec),
                   "shifted_position_rel_rms_err": rel_rms(shifted, dec),
                   "max_abs_diff": float((ver - dec).abs().max())}
            if first is not None:
                a, z = int(want[r, j]), int(got[r, j])
                top2 = dec.topk(2).values
                row.update(top2_gap=float(top2[0] - top2[1]),
                           pair_diff=float((dec[a] - ver[a]).abs()
                                           + (dec[z] - ver[z]).abs()))
            rows.append(row)
        accepted = stats["accepted"].tolist()
        emit("speculative", draft=name, target="llama3_8b",
             draft_layers=d_cfg.n_layers, prompts=lens, k_spec=k_spec,
             max_new_tokens=n_new, rounds=stats["rounds"],
             accepted=accepted,
             mean_accepted_per_round=sum(accepted) / (b * stats["rounds"]),
             seconds=spec_s, tokens_per_s=b * n_new / spec_s,
             greedy_seconds=greedy_s,
             greedy_tokens_per_s=b * n_new / greedy_s, tol=tol,
             rows_diverging=sum(x["first_divergence"] is not None
                                for x in rows),
             held=rows, launches=counts[name])
        for x in rows:
            bad_gap = x["first_divergence"] is not None and \
                not x["top2_gap"] <= x["pair_diff"]
            if not x["logits_rel_rms_err"] <= tol < \
                    x["shifted_position_rel_rms_err"] or bad_gap:
                raise AssertionError(
                    f"speculative {name} row {x['row']}: verify logits "
                    f"{x['logits_rel_rms_err']} from the decode's (tol "
                    f"{tol}; one position off gives "
                    f"{x['shifted_position_rel_rms_err']}); {x}")
        # the target as its own draft: every proposal is accepted but where
        # its decode and the verify round a near-tie apart (at random
        # weights the logits are flat and near-ties common)
        if name == "self" and sum(accepted) < 0.6 * k_spec * b * \
                stats["rounds"]:
            raise AssertionError(f"self draft accepted {accepted} in "
                                 f"{stats['rounds']} rounds")
        del verify, got
    del draft_params, decode_logits
    return counts


# ---------------------------------------------------------------------------
# State placed across ranks (slice 7) at Llama-3-8B's full width: every
# place of each mesh on this card
# ---------------------------------------------------------------------------

PLACED_AXES = {"fsdp": 2, "tp": 2}
PP_STAGES = 4
# the limit of the gradient checks (check_grad): bf16 models whose
# products round at other points
GRAD_TOL = 5e-2


def expected_chunk(x, spec, mesh, place: int):
    """``x`` cut by ``spec`` for the place at flat position ``place`` of
    ``mesh``, written apart from ``parallel.sharding``: each dimension
    ``torch.chunk``ed into the product of its axes' sizes, the first axis
    major, and the place's piece taken."""
    coords = dict(zip(mesh.axis_names,
                      np.unravel_index(place, mesh.devices.shape)))
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        k, n = 0, 1
        for ax in ((entry,) if isinstance(entry, str) else entry):
            k, n = k * mesh.shape[ax] + int(coords[ax]), n * mesh.shape[ax]
        x = x.chunk(n, dim=d)[k]
    return x


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages ``tensors`` use."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def check_placement(torch, cfg, params):
    """``shard_tree`` of the full-depth parameters and their AdamW state
    under fsdp_tp on {fsdp 2, tp 2}, every place on this card: each chunk
    is its slice of the unplaced tensor (equal, and the same memory),
    places holding one index range share one tensor (one data_ptr), and
    the placed state's bytes are the unplaced state's. Control: a
    placement that copies its replicas must fail the bytes check."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.sharding import ShardedTensor, shard_tree
    from ray_tpu_torch.train.state import TrainState, state_logical_axes
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(mesh_axes=PLACED_AXES,
                                       strategy="fsdp_tp"))
    state = TrainState.create(params, trainer.optimizer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = shard_tree(state, state_logical_axes(
        state, llama.param_logical_axes(cfg)), trainer.mesh, trainer.rules)
    place_s = time.perf_counter() - t0
    pairs = [pair for key in ("mu", "nu") for pair in zip(
        named_leaves(state.opt_state[key]),
        named_leaves(placed.opt_state[key]))]
    pairs += list(zip(named_leaves(state.params),
                      named_leaves(placed.params)))
    mesh = trainer.mesh
    bad_slices, bad_shares, n_chunks, distinct = [], [], 0, []
    for (name, x), (_, st) in pairs:
        assert isinstance(st, ShardedTensor)
        by_range = {}
        for place, chunk in enumerate(st.chunks):
            want = expected_chunk(x, st.spec, mesh, place)
            n_chunks += 1
            if not (chunk.data_ptr() == want.data_ptr()
                    and chunk.shape == want.shape
                    and chunk.stride() == want.stride()
                    and torch.equal(chunk, want)):
                bad_slices.append(f"{name}@{place}")
            key = (want.data_ptr(), tuple(want.shape), want.stride())
            if by_range.setdefault(key, chunk) is not chunk:
                bad_shares.append(f"{name}@{place}")
        distinct += [c for _, c in st.distinct()]
    plain_bytes = storage_bytes([x for (_, x), _ in pairs])
    placed_bytes = storage_bytes(distinct)
    # control: the same placement with every replica a copy of its own
    copies = []
    for _, (_, st) in pairs:
        seen = set()
        for c in st.chunks:
            copies.append(c if id(c) not in seen else c.clone())
            seen.add(id(c))
    control_bytes = storage_bytes(copies)
    replicas = sum(len(st.chunks) - len(st.distinct())
                   for _, (_, st) in pairs)
    del copies
    emit("placement", config="llama3_8b", n_layers=cfg.n_layers,
         mesh=PLACED_AXES, strategy="fsdp_tp", leaves=len(pairs),
         chunks=n_chunks, distinct_chunks=len(distinct),
         shared_replicas=replicas, seconds=place_s,
         unplaced_bytes=plain_bytes, placed_bytes=placed_bytes,
         copied_replicas_bytes=control_bytes,
         chunks_not_their_slice=bad_slices[:8],
         replicas_not_shared=bad_shares[:8])
    if bad_slices or bad_shares or placed_bytes != plain_bytes or \
            control_bytes == plain_bytes or replicas == 0:
        raise AssertionError(
            f"placement: {len(bad_slices)} chunks not their slice, "
            f"{len(bad_shares)} replicas not shared, placed bytes "
            f"{placed_bytes} vs unplaced {plain_bytes}; the copying "
            f"control must differ: {control_bytes}")
    del placed, state, pairs, distinct


def grads_against(torch, name, got, want, controls, **fields):
    """Every leaf's gradient in ``got`` within GRAD_TOL relative RMS of
    ``want``; each control (name -> gradients) must exceed it somewhere.
    Emits the "grad" line with ``fields``."""
    errs = {n: rel_rms(g, want[n]) for n, g in got.items()}
    bad = {c: max(rel_rms(g, want[n]) for n, g in grads.items())
           for c, grads in controls.items()}
    emit("grad", path=name, rel_rms_err=errs, tol=GRAD_TOL,
         controls_max_rel_rms_err=bad, **fields)
    if max(errs.values()) > GRAD_TOL or min(bad.values()) <= GRAD_TOL:
        raise AssertionError(f"{name}: gradient rel err {errs} vs tol "
                             f"{GRAD_TOL}; every control must exceed it: "
                             f"{bad}")


def counted_grads(torch, trainer, params, batch, want_counts):
    """``trainer.loss_and_grads`` with the kernels' launches counted and
    held to ``want_counts``; the gradients by leaf name."""
    zero_counts()
    loss, grads = trainer.loss_and_grads(params, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != want_counts:
        raise AssertionError(f"launches in one gradient {counts}, "
                             f"expected {want_counts}")
    return float(loss), dict(named_leaves(grads)), counts


def check_placed_grad(torch, cfg, params):
    """The fsdp_tp gradient on {fsdp 2, tp 2} (four ranks of this card:
    each data rank one row, each tp rank 16 q and 4 kv heads) against the
    one-card gradient, at full width and depth 2 on [2, 2049], remat
    ``full``, the fused loss. Controls: a tp block without the psum
    after wo, and an fsdp gather with two chunks swapped."""
    import dataclasses

    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    depth = 2
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    params2 = first_layers(params, depth)
    batch = train_batch(cfg, 2, 2048, SEED + 9)
    kw = dict(fused_loss=True, loss_chunk=1024)
    one = Trainer(cfg2, TrainConfig(**kw))
    placed = Trainer(cfg2, TrainConfig(mesh_axes=PLACED_AXES,
                                       strategy="fsdp_tp", **kw))
    ranks = 4
    ref_loss, want, ref_counts = counted_grads(
        torch, one, params2, batch, {"flash_fwd": 2 * depth,
                                     "flash_bwd": depth})
    loss, got, counts = counted_grads(
        torch, placed, params2, batch,
        {"flash_fwd": 2 * depth * ranks, "flash_bwd": depth * ranks})
    controls = {}
    orig = spmd.reduce_attention
    spmd.reduce_attention = lambda parts: parts
    try:
        controls["no_psum_after_wo"] = dict(named_leaves(
            placed.loss_and_grads(params2, batch)[1]))
    finally:
        spmd.reduce_attention = orig

    def swapped(xs, **kwargs):
        xs = list(xs)
        xs[0], xs[1] = xs[1], xs[0]
        return collectives.all_gather(xs, **kwargs)
    orig = spmd.all_gather
    spmd.all_gather = swapped
    try:
        controls["fsdp_gather_chunks_swapped"] = dict(named_leaves(
            placed.loss_and_grads(params2, batch)[1]))
    finally:
        spmd.all_gather = orig
    grads_against(torch, "fsdp_tp", got, want, controls,
                  config="llama3_8b", n_layers=depth, tokens=[2, 2049],
                  mesh=PLACED_AXES, against="one_card", loss=loss,
                  reference_loss=ref_loss, launches=counts,
                  reference_launches=ref_counts)
    for _, t in named_leaves(params2):
        t.requires_grad_(False)
    return counts


def check_pp_grad(torch, cfg, params):
    """The 1F1B gradient of pp_fsdp on {pp 4} (one layer a stage, 4
    microbatches of one row) against the unpipelined one-card gradient,
    at full width and depth 4 on [4, 2049], remat ``full``. Control: a
    backward slot that reads the previous microbatch's stash slot."""
    import dataclasses

    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    depth, m = 4, 4
    cfg4 = dataclasses.replace(cfg, n_layers=depth)
    params4 = first_layers(params, depth)
    batch = train_batch(cfg, 4, 2048, SEED + 11)
    one = Trainer(cfg4, TrainConfig(fused_loss=True, loss_chunk=1024))
    pp = Trainer(cfg4, TrainConfig(mesh_axes={"pp": PP_STAGES},
                                   strategy="pp_fsdp", n_microbatches=m))
    ref_loss, want, ref_counts = counted_grads(
        torch, one, params4, batch, {"flash_fwd": 2 * depth,
                                     "flash_bwd": depth})
    # per layer and microbatch: K1 in the forward slot, in the backward
    # slot's re-run and in remat's recompute inside it; one backward
    loss, got, counts = counted_grads(
        torch, pp, params4, batch,
        {"flash_fwd": 3 * depth * m, "flash_bwd": depth * m})
    orig = pipeline._read_slot
    pipeline._read_slot = lambda b, window: max(b - 1, 0) % window
    try:
        bad = dict(named_leaves(pp.loss_and_grads(params4, batch)[1]))
    finally:
        pipeline._read_slot = orig
    grads_against(torch, "pp_fsdp_1f1b", got, want,
                  {"backward_reads_previous_stash_slot": bad},
                  config="llama3_8b", n_layers=depth, tokens=[4, 2049],
                  mesh={"pp": PP_STAGES}, n_microbatches=m,
                  against="one_card_unpipelined", loss=loss,
                  reference_loss=ref_loss, launches=counts,
                  reference_launches=ref_counts)
    for _, t in named_leaves(params4):
        t.requires_grad_(False)
    return counts


def check_gpipe(torch, cfg, params):
    """``llama_forward_pipelined`` at full depth on [4, 2048] over {pp 4}
    (8 layers a stage, 4 microbatches of one row) against
    ``llama.forward``, within the Llama forward's 5e-2 relative RMS.
    Control: the pipeline with stages 0 and 1 swapped."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"pp": PP_STAGES},
                       devices=[torch.device("cuda")] * PP_STAGES)
    tokens = train_batch(cfg, 4, 2047, SEED + 12)
    tol = 5e-2
    with torch.no_grad():
        zero_counts()
        t0 = time.perf_counter()
        got = pipeline.llama_forward_pipelined(cfg, params, tokens,
                                               mesh=mesh)
        torch.cuda.synchronize()
        pipelined_s = time.perf_counter() - t0
        counts = launch_counts()
        want = llama.forward(cfg, params, tokens)
        err = rel_rms(got, want)
        orig = pipeline.split_stages

        def swapped(stacked, n):
            return {k: v[[1, 0, 2, 3]] for k, v in orig(stacked, n).items()}
        pipeline.split_stages = swapped
        try:
            bad = rel_rms(pipeline.llama_forward_pipelined(
                cfg, params, tokens, mesh=mesh), want)
        finally:
            pipeline.split_stages = orig
    want_counts = {"flash_fwd": cfg.n_layers * 4, "flash_bwd": 0}
    emit("gpipe_forward", config="llama3_8b", n_layers=cfg.n_layers,
         tokens=[4, 2048], mesh={"pp": PP_STAGES}, n_microbatches=4,
         logits_rel_rms_err=err, tol=tol, stages_swapped_rel_rms_err=bad,
         seconds=pipelined_s, launches=counts, want_launches=want_counts)
    if not err <= tol < bad or counts != want_counts:
        raise AssertionError(f"GPipe forward rel err {err} vs tol {tol} "
                             f"(stages swapped: {bad}); launches {counts}")
    del got, want
    return counts


def check_placed_train(torch, cfg, peaks, *, name, axes, strategy, b,
                       steps, want, **kw):
    """The trainer on llama3_8b() at full depth over ``axes`` (every
    place on this card), from ``Trainer.init_state`` (the state placed by
    its shardings), ``steps`` steps on one repeated [b, 2049] batch; the
    kernels' launches held to ``want`` every step. Returns the last
    step's counts."""
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    s = 2048
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainConfig(mesh_axes=axes, strategy=strategy,
                                       warmup_steps=1, **kw))
    state = trainer.init_state(seed=SEED)
    batch = train_batch(cfg, b, s, SEED + 13)
    losses, times, norms, counts = [], [], [], []
    for _ in range(steps):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))   # synchronizes
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        counts.append(launch_counts())
    peak_bytes = torch.cuda.max_memory_allocated()
    abstract = trainer.abstract_state().params
    n_matmul = sum(abstract["blocks"][k].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + abstract["lm_head"].numel()
    L = cfg.n_layers
    step_s = float(np.median(times[1:]))
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    emit("placed_train", name=name, config="llama3_8b", n_layers=L,
         depth_cut=None, tokens=[b, s + 1], mesh=axes, strategy=strategy,
         remat=cfg.remat, **kw, steps=steps, losses=losses,
         grad_norms=norms, step_s=times, median_step_s=step_s,
         tokens_per_s=b * s / step_s, flops_per_step=flops,
         mfu=flops / step_s / peaks[0], peak_memory_bytes=peak_bytes,
         launches=counts, want_launches=want)
    check_losses(f"llama3_8b {name}", losses, cfg.vocab_size)
    if any(c != want for c in counts):
        raise AssertionError(f"{name} launches per step {counts}, want "
                             f"{want}")
    del state
    return counts[-1]


# ---------------------------------------------------------------------------
# The multi-process harness (slice 8): rank processes over torch.distributed,
# each spawned by the port's WorkerGroup; the launch counters are per
# process, so each rank sends its counts back with its stats
# ---------------------------------------------------------------------------

# The rank's first loss equals check_train's bit for bit (the same weights,
# batch and kernels; the step-1 update is at a learning rate of 0, so the
# second is equal too). The third parts run to run: the fused backward's
# float32 dQ sums and the embedding gradient's atomic adds change order,
# and Adam's first step, about lr times the gradient's sign, turns that
# into whole steps where a gradient is near 0. Two card runs read 4.5e-5
# and 5.5e-4 there, and check_train's own third loss moved by 1.1e-4
# between them; another batch seed (the control) moves it by 0.16
# (PERF.md section 6).
HARNESS_LOSS_TOL = 1e-2
# The dp-2 ranks' parameters after 2 steps against the single-controller
# trainer's on {dp 2}: the RMS of their difference over the RMS of the
# reference's update (the ranks sum the two halves' bf16 gradients over
# gloo, the single controller in autograd: Adam's first step turns a
# rounding only where a gradient is near 0 into another step).
HARNESS_PARAM_TOL = 0.1
# Rank 0's gradient norm a step against the single controller's, relative:
# the clip and Adam barely see a uniform scale of the gradients, so a mean
# in place of the sum (the control) shows only here.
HARNESS_NORM_TOL = 1e-2
# the cases of a gloo rank: the real one, then the controls (the gradient
# all-reduce made a no-op; the summed gradients divided by the world size)
GLOO_CASES = ("all_reduce", "skip_all_reduce", "mean_all_reduce")
GLOO_DEPTH = 4
ELASTIC_DEPTH = 2


def harness_steps(stats: dict) -> dict:
    """A rank's step walls, MFU and stages from its telemetry."""
    tel = stats["telemetry"]
    walls = [h["wall_s"] for h in tel["history"]]
    return {"step_s": walls, "median_step_s": float(np.median(walls[1:])),
            "telemetry_mfu": [h["mfu"] for h in tel["history"]],
            "stages": [h["stages"] for h in tel["history"]],
            "goodput": tel["goodput"], "flops_per_step": tel["flops_per_step"],
            "peak_flops": tel["peak_flops"]}


def check_harness_nccl(torch, cfg, peaks, want_losses, step_counts):
    """``TorchMeshTrainer`` over one NCCL rank on llama3_8b() at full
    width and depth: 3 steps on check_train's batch fed through the
    device feed from a numpy dataset. Held: the losses against
    check_train's; the control (the single-controller trainer from the
    same seed on another batch seed) must break that bound. Returns the
    rank's launch counts (3 steps)."""
    import tempfile

    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.train.data_parallel_trainer import TorchMeshTrainer
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    b, s, steps = 2, 2048, 3
    train_cfg = TrainConfig(fused_loss=True, loss_chunk=1024, warmup_steps=1)
    tokens = train_batch(cfg, b, s, SEED + 4).cpu().numpy()
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        result = TorchMeshTrainer(
            cfg, train_cfg,
            train_loop_config={"seed": SEED, "steps": steps,
                               "batch_size": b},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         backend="nccl"),
            run_config=RunConfig(storage_path=d),
            datasets={"train": {"tokens": np.concatenate([tokens] * steps)}}
        ).fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"harness_nccl failed:\n{result.error}")
    stats, = result.rank_stats
    losses = [m["loss"] for m in result.metrics_history]
    # the control, after the rank has finished: the parent trains here
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_cfg)
    abstract = trainer.abstract_state().params
    state = trainer.init_state(seed=SEED)
    other = train_batch(cfg, b, s, SEED + 5)
    control = []
    for _ in range(steps):
        state, m = trainer.train_step(state, other)
        control.append(float(m["loss"]))
    del state, trainer, other
    free_card(torch)
    control_s = time.perf_counter() - t0
    want = want_losses[:steps]

    def errs(ls):
        return ls[0] == want[0], max(abs(a - w) for a, w in
                                     zip(ls[1:], want[1:]))

    def breaks(ls):
        equal, later = errs(ls)
        return len(ls) != steps or not equal or later > HARNESS_LOSS_TOL

    n_matmul = sum(abstract["blocks"][k].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + abstract["lm_head"].numel()
    timing = harness_steps(stats)
    want_counts = {k: steps * v for k, v in step_counts.items()}
    emit("harness_nccl", config="llama3_8b", n_layers=cfg.n_layers,
         tokens=[b, s + 1], steps=steps, backend="nccl", world_size=1,
         device=stats["device_name"], losses=losses,
         check_train_losses=want, first_loss_bit_equal=errs(losses)[0],
         later_max_abs_err=errs(losses)[1], tol=HARNESS_LOSS_TOL,
         control_batch_seed=SEED + 5, control_losses=control,
         control_first_loss_bit_equal=errs(control)[0],
         control_later_max_abs_err=errs(control)[1], **timing,
         tokens_per_s=b * s / timing["median_step_s"],
         step_flops_mfu=step_flops(n_matmul, b, s, cfg.n_layers, cfg.n_heads,
                                   cfg.head_dim)
         / timing["median_step_s"] / peaks[0],
         spawn_to_first_report_s=result.first_report_s, fit_s=fit_s,
         control_s=control_s, peak_memory_bytes=stats["peak_memory_bytes"],
         launches=stats["launches"], want_launches=want_counts,
         process_group=stats["process_group"])
    if breaks(losses) or not breaks(control):
        raise AssertionError(
            f"harness losses {losses} against check_train's {want} (first "
            f"bit-equal, later within {HARNESS_LOSS_TOL}); the control "
            f"{control} must break that")
    if stats["launches"] != want_counts:
        raise AssertionError(f"harness_nccl launches {stats['launches']}, "
                             f"want {want_counts}")
    return stats["launches"]


def gloo_rank_loop(config):
    """A rank of harness_gloo_dp2: ``Trainer`` over the rank's process
    group from ``init_state(seed)``, ``steps`` steps on the global batch
    for each case of ``GLOO_CASES`` (the real one, then the controls).
    Reports each step; rank 0 saves each case's parameters to
    ``<out>/<case>.pt``; after the real case both ranks must hold equal
    parameters (``check_same``)."""
    import torch

    from ray_tpu_torch.parallel.process_group import ProcessGroup
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.trainer import Trainer

    ctx = session.get_context()
    pg = ctx.process_group
    batch = torch.from_numpy(config["batch"]).to(ctx.device)
    real = ProcessGroup.all_reduce_grads

    def mean(self, grads):
        real(self, grads)
        for g in grads:
            g.div_(self.world_size)
    # this rank's work: 6 FLOPs a parameter a token of its rows
    session.set_flops_per_step(6.0 * config["n_params"] * batch.numel()
                               / ctx.world_size)
    for case in GLOO_CASES:
        trainer = Trainer(config["model_config"], config["train_config"],
                          device=ctx.device, process_group=pg)
        state = trainer.init_state(seed=SEED)
        if case == "skip_all_reduce":
            ProcessGroup.all_reduce_grads = lambda self, grads: None
        elif case == "mean_all_reduce":
            ProcessGroup.all_reduce_grads = mean
        try:
            for _ in range(config["steps"]):
                before = dict(pg.stats)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, batch)
                loss = float(m["loss"])
                session.report({
                    "case": case, "loss": loss,
                    "grad_norm": float(m["grad_norm"]),
                    "step_s": time.perf_counter() - t0,
                    **{k: pg.stats[k] - before[k] for k in (
                        "grad_all_reduce_s", "staging_s", "staged_bytes")}})
        finally:
            ProcessGroup.all_reduce_grads = real
        named = named_leaves(state.params)
        if case == "all_reduce":
            pg.check_same(named)
        if ctx.rank == 0:
            torch.save({n: t.detach().cpu() for n, t in named},
                       os.path.join(config["out"], f"{case}.pt"))
        del state, trainer, named
        gc.collect()
        torch.cuda.empty_cache()


def update_err(torch, got: dict, ref: dict, init: dict) -> tuple:
    """The RMS of ``got - ref`` over the RMS of ``ref - init``, every
    leaf, and the count of elements of ``got`` not equal to ``ref``: host
    tensors, each leaf's arithmetic on the card (one leaf there at a
    time)."""
    num = den = 0.0
    differing = 0
    for n, r in ref.items():
        r = r.cuda()
        g = got[n].cuda()
        differing += int((g != r).sum())
        r = r.float()
        num += float((g.float() - r).square().sum(dtype=torch.float64))
        den += float((r - init[n].cuda().float()).square().sum(
            dtype=torch.float64))
    return (num / den) ** 0.5, differing


def check_harness_gloo(torch, cfg, peaks):
    """Two ranks on this one card over gloo (CUDA tensors staged through
    pinned host memory), llama3_8b() at full width and depth 4 on a
    {"dp": 2} global mesh, global batch [2, 2049], 2 steps. Held: rank 0's
    parameters and gradient norms against the single-controller trainer
    on a {"dp": 2} mesh of the card, run before the ranks start; the
    ranks' parameters equal each other (check_same in the ranks). The
    controls, ranks that skip the gradient all-reduce and ranks that
    average in place of the sum, must each break a bound. Returns rank
    0's launch counts (three cases, 6 steps)."""
    import dataclasses
    import tempfile

    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.parallel.sharding import ShardedTensor
    from ray_tpu_torch.train.data_parallel_trainer import \
        DataParallelTrainer
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    b, s, steps, world = 2, 2048, 2, 2
    cfg4 = dataclasses.replace(cfg, n_layers=GLOO_DEPTH)
    train_cfg = TrainConfig(mesh_axes={"dp": world}, fused_loss=True,
                            loss_chunk=1024, warmup_steps=1)
    batch = train_batch(cfg, b, s, SEED + 17)

    def host(params):
        return {n: (t.unshard() if isinstance(t, ShardedTensor) else t)
                .detach().cpu() for n, t in named_leaves(params)}

    t0 = time.perf_counter()
    trainer = Trainer(cfg4, train_cfg)
    state = trainer.init_state(seed=SEED)
    init = host(state.params)
    ref_losses, ref_norms = [], []
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
        ref_losses.append(float(m["loss"]))
        ref_norms.append(float(m["grad_norm"]))
    ref = host(state.params)
    del state, trainer
    free_card(torch)
    reference_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        result = DataParallelTrainer(
            gloo_rank_loop,
            train_loop_config={"model_config": cfg4,
                               "train_config": train_cfg,
                               "batch": batch.cpu().numpy(), "steps": steps,
                               "n_params": sum(t.numel()
                                               for t in init.values()),
                               "out": d},
            scaling_config=ScalingConfig(num_workers=world, use_gpu=True,
                                         backend="gloo"),
            run_config=RunConfig(storage_path=d)).fit()
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            raise AssertionError(f"harness_gloo_dp2 failed:\n{result.error}")
        t0 = time.perf_counter()
        errs, differing = {}, {}
        for case in GLOO_CASES:
            got = torch.load(os.path.join(d, f"{case}.pt"),
                             weights_only=True, mmap=True)
            errs[case], differing[case] = update_err(torch, got, ref, init)
            del got
        compare_s = time.perf_counter() - t0
    del init, ref
    per_rank = []
    for stats in result.rank_stats:
        per_rank.append({"rank": stats["rank"],
                         "peak_memory_bytes": stats["peak_memory_bytes"],
                         "launches": stats["launches"],
                         "process_group": stats["process_group"],
                         **harness_steps(stats)})
    reports = result.metrics_history
    real = [r for r in reports if r["case"] == "all_reduce"]
    norms = {case: [r["grad_norm"] for r in reports if r["case"] == case]
             for case in GLOO_CASES}
    norm_errs = {case: max(abs(a / w - 1.0) for a, w in zip(ns, ref_norms))
                 for case, ns in norms.items()}
    L = cfg4.n_layers
    want_counts = {"flash_fwd": len(GLOO_CASES) * steps * 2 * L,
                   "flash_bwd": len(GLOO_CASES) * steps * L}
    emit("harness_gloo_dp2", config="llama3_8b", n_layers=L,
         depth_cut=f"{GLOO_DEPTH} of {cfg.n_layers} layers (two states on "
                   "one card)", tokens=[b, s + 1], steps=steps,
         backend="gloo", world_size=world, mesh={"dp": world},
         reference_losses=ref_losses,
         losses=[r["loss"] for r in real],
         update_rel_err=errs["all_reduce"], tol=HARNESS_PARAM_TOL,
         reference_grad_norms=ref_norms, grad_norms=norms["all_reduce"],
         grad_norm_rel_err=norm_errs["all_reduce"],
         norm_tol=HARNESS_NORM_TOL,
         elements_differing=differing["all_reduce"],
         controls={case: {"update_rel_err": errs[case],
                          "elements_differing": differing[case],
                          "grad_norms": norms[case],
                          "grad_norm_rel_err": norm_errs[case],
                          "losses": [r["loss"] for r in reports
                                     if r["case"] == case]}
                   for case in GLOO_CASES[1:]},
         rank0_step_s=[r["step_s"] for r in real],
         rank0_all_reduce_s=[r["grad_all_reduce_s"] for r in real],
         rank0_staging_s=[r["staging_s"] for r in real],
         rank0_staged_bytes=[r["staged_bytes"] for r in real],
         ranks=per_rank, want_launches=want_counts,
         reference_s=reference_s, fit_s=fit_s, compare_s=compare_s,
         spawn_to_first_report_s=result.first_report_s)
    def breaks(case):
        return errs[case] > HARNESS_PARAM_TOL or \
            norm_errs[case] > HARNESS_NORM_TOL
    if breaks("all_reduce") or not all(map(breaks, GLOO_CASES[1:])):
        raise AssertionError(
            f"dp-2 ranks' update error {errs} (tol {HARNESS_PARAM_TOL}), "
            f"gradient norm error {norm_errs} (tol {HARNESS_NORM_TOL}): "
            "the real case within both, each control outside one")
    if any(r["launches"] != want_counts for r in per_rank):
        raise AssertionError(f"harness_gloo_dp2 launches "
                             f"{[r['launches'] for r in per_rank]}, want "
                             f"{want_counts}")
    return per_rank[0]["launches"]


def elastic_axes(n: int) -> dict:
    return {"dp": 2, "fsdp": n // 2} if n > 2 else {"dp": n}


def check_elastic(torch, cfg):
    """``ElasticTrainer`` on llama3_8b() at full width and depth 2: 2
    steps on {"dp": 2, "fsdp": 2} places of this card with a checkpoint at
    step 2 (into a temporary directory), ``reform`` onto {"dp": 2}, one
    more step. Held: the restored state (parameters, moments, step)
    bit-equal to the saved one; the step after the reform finite, its
    launches those of {"dp": 2}. Returns that step's counts."""
    import dataclasses
    import tempfile

    from ray_tpu_torch.parallel.sharding import ShardedTensor
    from ray_tpu_torch.train.elastic import ElasticTrainer
    from ray_tpu_torch.train.telemetry import run_goodput
    from ray_tpu_torch.train.trainer import TrainConfig

    b, s = 4, 2048
    cfg2 = dataclasses.replace(cfg, n_layers=ELASTIC_DEPTH)
    card = torch.device("cuda", torch.cuda.current_device())
    batch = train_batch(cfg, b, s, SEED + 19)

    def flat(state):
        return {n: t.unshard() if isinstance(t, ShardedTensor) else t
                for n, t in named_leaves({"params": state.params,
                                          "mu": state.opt_state["mu"],
                                          "nu": state.opt_state["nu"]})}

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        et = ElasticTrainer(
            cfg2, TrainConfig(fused_loss=True, loss_chunk=1024,
                              warmup_steps=1),
            checkpoint_dir=d, mesh_axes_fn=elastic_axes,
            devices=[card] * 4, checkpoint_every=2,
            run_name="chip-smoke-elastic")
        mesh_before = et.trainer.mesh.shape
        state = et.init_state(seed=SEED)
        losses = []
        state = et.fit(state, iter([batch] * 2), steps=2,
                       on_metrics=lambda m: losses.append(m["loss"]))
        saved = {n: t.clone() for n, t in flat(state).items()}
        saved_step = state.step
        del state
        free_card(torch)
        state = et.reform(devices=[card] * 2)
        mismatched = [n for n, t in flat(state).items()
                      if not torch.equal(t, saved[n])]
        del saved
        zero_counts()
        state, m = et.trainer.train_step(state, batch)
        after = float(m["loss"])
        counts = launch_counts()
        event, = et.reform_events
        et.close()
        del state, et
    free_card(torch)
    want = {"flash_fwd": 2 * 2 * ELASTIC_DEPTH, "flash_bwd": 2 * ELASTIC_DEPTH}
    emit("elastic", config="llama3_8b", n_layers=ELASTIC_DEPTH,
         depth_cut=f"{ELASTIC_DEPTH} of {cfg.n_layers} layers",
         tokens=[b, s + 1], mesh_before=mesh_before,
         mesh_after={"dp": 2}, losses=losses, saved_step=saved_step,
         restored_step=event.step, restored_leaves_not_bit_equal=mismatched,
         loss_after_reform=after, reform_s=event.seconds,
         restart_bucket_s=run_goodput("chip-smoke-elastic")["restart"],
         launches_after_reform=counts, want_launches=want,
         seconds=time.perf_counter() - t_start)
    if mismatched or event.step != saved_step or not np.isfinite(after):
        raise AssertionError(f"elastic reform: leaves {mismatched} differ, "
                             f"step {event.step} vs {saved_step}, loss "
                             f"{after}")
    if counts != want:
        raise AssertionError(f"elastic launches {counts}, want {want}")
    return counts


def check_gpt(torch, peaks) -> dict:
    """gpt2_xl() at full width and depth (48 layers, 25 heads of 64, tied
    head), bf16, seeded random weights: the forward over [8, 1024] through
    K1 against reference attention; the gradient at depth 2 against
    reference attention; then the trainer on [8, 1025] tokens under remat
    "full". Returns the launch counts of the forward and of one step."""
    import dataclasses

    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = gpt.gpt2_xl()
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", config="gpt2_xl", params=gpt.num_params(params),
         seconds=time.perf_counter() - t0)
    b, s = 8, 1024
    batch = train_batch(cfg, b, s, SEED + 5)
    t_phase = time.perf_counter()
    logits, _, errs, fwd_counts, (forward_s, reference_s) = \
        forward_against_reference(torch, lambda impl: gpt.forward(
            cfg, params, batch[:, :-1], attn_impl=impl), gpt)
    if fwd_counts != {"flash_fwd": cfg.n_layers, "flash_bwd": 0} or \
            logits.shape != (b, s, cfg.vocab_size):
        raise AssertionError(f"gpt2_xl forward: launches {fwd_counts}, "
                             f"logits {tuple(logits.shape)}")
    del logits
    emit("model", config="gpt2_xl", n_layers=cfg.n_layers, tokens=[b, s],
         launches=fwd_counts, forward_s=forward_s,
         reference_forward_s=reference_s, tol=FAMILY_FORWARD_TOL, **errs,
         seconds=time.perf_counter() - t_phase)
    hold_forward("gpt2_xl", errs, FAMILY_FORWARD_TOL)

    depth = 2
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    params2 = first_layers(params, depth)

    def loss(attn_impl):
        logits = gpt.forward(cfg2, params2, batch[:, :-1],
                             attn_impl=attn_impl)
        return llama.cross_entropy_loss(logits, batch[:, 1:])

    grads_against_reference(
        torch, params2, loss, gpt,
        {"flash_fwd": 2 * depth, "flash_bwd": depth}, config="gpt2_xl",
        n_layers=depth, tokens=[b, s + 1])
    del params2
    free_card(torch)

    steps = 5
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainConfig(warmup_steps=1))
    state = TrainState.create(params, trainer.optimizer)
    losses, times, norms = [], [], []
    for i in range(steps):
        if i == steps - 1:
            zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))   # synchronizes
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    step_counts = launch_counts()
    step_s = float(np.median(times[1:]))
    # matmul parameters: the blocks' four matrices and the tied head
    n_matmul = sum(params["blocks"][k].numel() for k in
                   ("wqkv", "wo", "w_up", "w_down")) + \
        params["embedding"].numel()
    flops = step_flops(n_matmul, b, s, cfg.n_layers, cfg.n_heads,
                       cfg.head_dim)
    emit("train", config="gpt2_xl", n_layers=cfg.n_layers,
         tokens=[b, s + 1], remat=cfg.remat, steps=steps, losses=losses,
         grad_norms=norms, step_s=times, median_step_s=step_s,
         tokens_per_s=b * s / step_s, matmul_params=n_matmul,
         flops_per_step=flops, mfu=flops / step_s / peaks[0],
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=step_counts)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd": cfg.n_layers}
    if step_counts != want:
        raise AssertionError(f"gpt2_xl launches in one step {step_counts}, "
                             f"expected {want}")
    check_losses("gpt2_xl", losses, cfg.vocab_size)
    return {"forward": fwd_counts, "train_step_full": step_counts}


def to_cpu(tree):
    return {k: (to_cpu(v) if isinstance(v, dict) else v.detach().cpu())
            for k, v in tree.items()}


def card_against_cpu(torch, name, run, params, inputs):
    """``run(params, *inputs)`` on the card against the same port code on
    the CPU, both in float32 (TF32 off), with a control: the card's run
    with bf16 parameters and inputs must miss the limit. The CPU path is
    the one the CPU tests hold to the JAX package, so this ties the card
    to JAX. Returns the relative RMS error."""
    tol = 1e-3
    got = run(params, *inputs)
    want = run(to_cpu(params), *(x.cpu() for x in inputs))
    low = run({k: ({n: w.bfloat16() for n, w in v.items()}
                   if isinstance(v, dict) else v.bfloat16())
               for k, v in params.items()},
              *(x.bfloat16() if x.is_floating_point() else x
                for x in inputs))
    err, err_low = rel_rms(got.cpu(), want), rel_rms(low.float().cpu(), want)
    emit("card_vs_cpu", config=name, shape=list(got.shape), tol=tol,
         rel_rms_err=err, bf16_rel_rms_err=err_low)
    if not err <= tol < err_low:
        raise AssertionError(f"{name} card vs CPU rel err {err}, tol {tol} "
                             f"(bf16 gives {err_low}; the tolerance must "
                             "sit between)")
    return err


def mlm_batch(cfg, b, s, seed):
    """An MLM batch on the card from a numpy seed: each row real for a
    random length in [s/2, s] and padded after; 15% of the real positions
    masked (id 103) with the original ids as targets; token types 0 then
    1 from the middle of each row."""
    import torch

    rng = np.random.default_rng(seed)
    targets = rng.integers(1000, cfg.vocab_size, (b, s))
    real = np.arange(s)[None, :] < rng.integers(s // 2, s + 1, b)[:, None]
    masked = (rng.random((b, s)) < 0.15) & real
    batch = {"tokens": np.where(masked, 103, np.where(real, targets, 0)),
             "targets": targets, "attention_mask": real,
             "loss_mask": masked,
             "token_type_ids": (np.arange(s)[None, :] >= s // 2)
             .repeat(b, 0)}
    return {k: torch.from_numpy(v.astype(np.int64)).cuda()
            for k, v in batch.items()}


def check_bert(torch, peaks) -> dict:
    """bert_large() at full width and depth, bf16, through the trainer's
    loss_fn hook wrapping mlm_loss, on [8, 512] tokens with seeded padding
    and 15% MLM positions: attention is non-causal with segment ids, so
    no kernel may launch. Then the same port code at depth 2 and full
    width in float32 on the card against the CPU."""
    import dataclasses

    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = bert.bert_large()
    b, s, steps = 8, 512, 4

    def mlm(model_cfg, params, batch):
        return bert.mlm_loss(model_cfg, params, batch["tokens"],
                             batch["targets"],
                             attention_mask=batch["attention_mask"],
                             loss_mask=batch["loss_mask"])

    trainer = Trainer(cfg, TrainConfig(warmup_steps=1), loss_fn=mlm)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(seed=SEED)
    batch = mlm_batch(cfg, b, s, SEED + 6)
    losses, times = [], []
    zero_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    step_s = float(np.median(times[1:]))
    emit("train", config="bert_large", n_layers=cfg.n_layers, tokens=[b, s],
         remat=cfg.remat, loss="mlm_loss through loss_fn", steps=steps,
         losses=losses, step_s=times, median_step_s=step_s,
         tokens_per_s=b * s / step_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=counts)
    if counts != {"flash_fwd": 0, "flash_bwd": 0}:
        raise AssertionError(f"bert_large launched kernels {counts}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[1]):
        raise AssertionError(f"bert_large losses {losses}")
    del state, trainer
    free_card(torch)

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    small = mlm_batch(cfg2, 2, s, SEED + 7)
    card_against_cpu(
        torch, "bert_large_depth2_f32",
        lambda p, t, mask, types: bert.encode(
            cfg2, p, t, attention_mask=mask, token_type_ids=types),
        bert.init_params(cfg2, seed=SEED + 1, device="cuda"),
        (small["tokens"], small["attention_mask"], small["token_type_ids"]))
    return {"train_step": counts}


def check_vit(torch) -> dict:
    """vit_l16() at full depth in float32: the forward on [32, 224, 224,
    3] seeded images, then gradient steps with Adam (a constant 1e-4, no
    decay or clip) on seeded labels; then the same port code at depth 2 on
    the card against the CPU."""
    import dataclasses

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.train.optim import AdamW, tree_leaves

    cfg = vit.vit_l16()
    params = vit.init_params(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    images = torch.rand((32, cfg.image_size, cfg.image_size, cfg.channels),
                        generator=gen, device="cuda")
    labels = torch.randint(0, cfg.n_classes, (32,), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits = vit.forward(cfg, params, images)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    if logits.shape != (32, cfg.n_classes) or \
            logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        raise AssertionError(f"vit_l16 logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = AdamW(lambda count: 1e-4, max_grad_norm=float("inf"), b1=0.9,
                b2=0.999, weight_decay=0.0)
    opt_state = opt.init(params)
    losses, times = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = torch.nn.functional.cross_entropy(
            vit.forward(cfg, params, images), labels)
        grads = torch.autograd.grad(loss, leaves)
        opt.update(leaves, list(grads), opt_state)
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t0)
        del grads, loss
    counts = launch_counts()
    emit("vit", config="vit_l16", n_layers=cfg.n_layers,
         images=[32, cfg.image_size, cfg.image_size, cfg.channels],
         dtype="float32", forward_s=forward_s, step_s=times, losses=losses,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=counts)
    if counts != {"flash_fwd": 0, "flash_bwd": 0} or \
            not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"vit_l16 steps: losses {losses}, launches "
                             f"{counts}")
    del params, opt_state, leaves, logits
    free_card(torch)

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    card_against_cpu(torch, "vit_l16_depth2_f32",
                     lambda p, x: vit.forward(cfg2, p, x),
                     vit.init_params(cfg2, seed=SEED + 1, device="cuda"),
                     (images[:4],))
    return {"steps": counts}


class Routing:
    """While installed, records or replays each Mixtral layer's top-k
    expert choice, keyed by the layer's router weight (the same view when
    a remat recompute reruns the layer): it wraps ``mixtral.moe_ffn`` and,
    inside it, ``ops.moe._top_k``. Recording changes nothing. Replaying
    ``replay``'s choice makes every token go to the experts, in the slot
    order, that it went to in the recorded run; the gate values are this
    run's own probabilities of those experts. Routing is discontinuous: a
    token whose top-2 set flips under attention's rounding changes its
    output by a whole expert, so two attentions are compared with the
    routing held fixed, and the flips are counted apart."""

    def __init__(self, replay: "Routing | None" = None):
        self.replay = replay
        self.choice = {}     # router data_ptr -> [T, k] expert ids

    def __enter__(self):
        from ray_tpu_torch.models import mixtral
        from ray_tpu_torch.ops import moe

        orig_ffn, orig_top_k = mixtral.moe_ffn, moe._top_k

        def ffn(x, router_w, *args, **kwargs):
            key = router_w.data_ptr()
            if self.replay is not None:
                idx = self.replay.choice[key]

                def top_k(probs, k):
                    return probs.gather(-1, idx), idx
            else:
                def top_k(probs, k):
                    vals, idx = orig_top_k(probs, k)
                    self.choice.setdefault(key, idx.detach())
                    return vals, idx
            moe._top_k = top_k
            try:
                return orig_ffn(x, router_w, *args, **kwargs)
            finally:
                moe._top_k = orig_top_k

        mixtral.moe_ffn = ffn
        self._restore = lambda: setattr(mixtral, "moe_ffn", orig_ffn)
        return self

    def __exit__(self, *exc):
        self._restore()

    def flips(self, other) -> list:
        """Per layer, the share of tokens whose top-k set differs from
        ``other``'s."""
        return [float((a.sort(-1).values != b.sort(-1).values).any(-1)
                      .float().mean())
                for a, b in zip(self.choice.values(), other.choice.values())]

    def dropped_share(self, cfg) -> list:
        """Per layer, the share of the top-k assignments that capacity
        dropped: an expert chosen n times keeps min(n, C) of them."""
        out = []
        for idx in self.choice.values():
            t = idx.shape[0]
            cap = max(1, int(cfg.capacity_factor * t * cfg.top_k
                             / cfg.n_experts))
            n = idx.flatten().bincount(minlength=cfg.n_experts)
            out.append(float((n - cap).clamp(min=0).sum()) / (t * cfg.top_k))
        return out


def fixed_routing(recorded):
    """The ``ctx`` of the comparisons: the flash run records its routing,
    the reference run and the control replay it."""
    return lambda role: recorded if role == "flash" else Routing(recorded)


def mixtral_forwards(torch, cfg, params) -> dict:
    """The forward over [1, 2048] through K1 at depth 16 and at depth 2
    (the first layers of ``params``) against reference attention with the
    flash run's routing, the float8 control failing the limit; the
    natural routing's error and flips reported. Returns the depth-16
    launch counts."""
    import dataclasses

    from ray_tpu_torch.models import llama, mixtral

    tokens = train_batch(cfg, 1, 2047, SEED + 9)     # [1, 2048]
    tol = FAMILY_FORWARD_TOL
    results = {}
    for depth in (16, 2):
        cfg_d = dataclasses.replace(cfg, n_layers=depth)
        p_d = first_layers(params, depth)
        aux = []

        def forward(impl):
            out, a = mixtral.forward(cfg_d, p_d, tokens, attn_impl=impl,
                                     return_aux_loss=True)
            aux.append(a)
            return out
        flash = Routing()
        logits, ref, errs, counts, (forward_s, reference_s) = \
            forward_against_reference(torch, forward, llama,
                                      fixed_routing(flash))
        if counts != {"flash_fwd": depth, "flash_bwd": 0}:
            raise AssertionError(f"mixtral depth {depth} forward launches "
                                 f"{counts}")
        # the same reference forward with its own routing
        with Routing() as natural:
            ref_natural = forward("reference")
        natural_err = rel_rms(logits, ref_natural)
        natural_agree = float((logits.argmax(-1) == ref_natural.argmax(-1))
                              .float().mean())
        del logits, ref, ref_natural
        emit("model", config="mixtral_8x7b", n_layers=depth,
             tokens=[1, 2048], launches=counts, forward_s=forward_s,
             reference_forward_s=reference_s, routing="fixed", tol=tol,
             **errs, natural_routing_logits_rel_rms_err=natural_err,
             natural_routing_argmax_agreement=natural_agree,
             routing_flip_share=flash.flips(natural),
             aux_loss=float(aux[1]),
             capacity_dropped_share=flash.dropped_share(cfg))
        hold_forward(f"mixtral_8x7b depth {depth}", errs, tol)
        results[depth] = counts
    return results[16]


def mixtral_grad(torch, cfg, params, batch) -> dict:
    """The gradient of the loss (cross-entropy plus the weighted aux loss,
    loss_fn's sum) at depth 2 on ``batch`` against reference attention
    with the flash run's routing; the natural routing's error and flips
    reported. Returns the launch counts."""
    import dataclasses

    from ray_tpu_torch.models import llama, mixtral

    depth = 2
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    params2 = first_layers(params, depth)

    def loss(attn_impl):
        logits, aux = mixtral.forward(cfg2, params2, batch[:, :-1],
                                      attn_impl=attn_impl,
                                      return_aux_loss=True)
        return llama.cross_entropy_loss(logits, batch[:, 1:]) + aux

    flash = Routing()
    counts, got = grads_against_reference(
        torch, params2, loss, llama,
        {"flash_fwd": 2 * depth, "flash_bwd": depth},
        ctx=fixed_routing(flash), config="mixtral_8x7b", n_layers=depth,
        tokens=[2, 2049], routing="fixed")
    # the reference gradient with its own routing, for the record
    names, leaves = zip(*named_leaves(params2))
    for t in leaves:
        t.requires_grad_(True)
    with Routing() as natural:
        want = torch.autograd.grad(loss("reference"), leaves,
                                   allow_unused=True, materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    emit("grad_natural_routing", config="mixtral_8x7b", n_layers=depth,
         rel_rms_err={n: rel_rms(got[n], w) for n, w in zip(names, want)},
         routing_flip_share=flash.flips(natural))
    return counts


def mixtral_train(torch, cfg, params, batch):
    """Three steps of the trainer's AdamW recipe over loss_fn on
    ``params`` (the depth-4 copy), the loss falling."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.train.optim import tree_leaves
    from ray_tpu_torch.train.trainer import TrainConfig, make_optimizer

    allocated = torch.cuda.memory_allocated()   # the depth-4 weights only
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer(TrainConfig(warmup_steps=0))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt_state = opt.init(params)
    losses, times = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = mixtral.loss_fn(cfg, params, batch[:, :-1], batch[:, 1:])
        grads = torch.autograd.grad(loss, leaves)
        opt.update(leaves, list(grads), opt_state)
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t0)
        del grads, loss
    emit("train", config="mixtral_8x7b", n_layers=cfg.n_layers,
         tokens=list(batch.shape), remat=cfg.remat,
         optimizer="AdamW (the trainer's recipe)",
         params=mixtral.num_params(params), steps=3, losses=losses,
         step_s=times,
         state_bytes=4 * sum(t.numel() * t.element_size() for t in leaves),
         allocated_before_bytes=allocated,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"mixtral training losses {losses}")


def check_mixtral(torch, peaks) -> dict:
    """mixtral_8x7b() at full width (46.7 B parameters do not fit the
    card's 80 GB at 32 layers): the forwards at depth 16 and 2, the
    gradient at depth 2 on [2, 2049] (``mixtral_forwards``,
    ``mixtral_grad``), then three AdamW steps at depth 4 on a copy of the
    first four layers, once the depth-16 weights are gone."""
    import dataclasses

    from ray_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.mixtral_8x7b(), n_layers=16)
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", config="mixtral_8x7b", n_layers=cfg.n_layers,
         params=mixtral.num_params(params), seconds=time.perf_counter() - t0)
    forward_counts = mixtral_forwards(torch, cfg, params)
    batch = train_batch(cfg, 2, 2048, SEED + 10)
    grad_counts = mixtral_grad(torch, cfg, params, batch)
    depth = 4
    params4 = {k: ({n: w[:depth].clone() for n, w in v.items()}
                   if k == "blocks" else v.clone())
               for k, v in params.items()}
    del params
    free_card(torch)
    mixtral_train(torch, dataclasses.replace(cfg, n_layers=depth), params4,
                  batch)
    del params4
    free_card(torch)
    return {"forward": forward_counts, "grad": grad_counts}


def build_facts(kernels_mod, name, path, kernel) -> dict:
    """What the card runs for one Hopper kernel, from library ``name``:
    its SASS counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions,
    and for each bf16 instance of ``kernel`` (one per head dim) the
    registers and spill bytes ptxas reported. Raises if the design did not
    make it into the binary: no HGMMA or UTMALDG, a spill in a bf16
    instance, setmaxnreg ignored (C7508), or a wgmma serialized (C75xx
    "serialized")."""
    import re

    log = path.with_suffix(".log").read_text()
    sass = kernels_mod.sass(name)
    facts = {"HGMMA": len(re.findall(r"\bHGMMA\.", sass)),
             "UTMALDG": len(re.findall(r"\bUTMALDG\b", sass)),
             "instances": {}, "ptxas_notes": []}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            d = re.search(rf"{kernel}ILi(\d+)E", m.group(1))
            current = f"bf16_d{d.group(1)}" if d else None
            if current:
                facts["instances"][current] = {}
        elif current and "spill stores" in line:
            facts["instances"][current]["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif current and "Used" in line:
            facts["instances"][current]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        if "setmaxnreg ignored" in line or re.search(r"\(C75\d\d\)", line):
            facts["ptxas_notes"].append(line.split("info    :")[-1].strip()[:200])
    bad = [f"{k} {v}" for k, v in facts["instances"].items()
           if v.get("spill_bytes", 1) != 0]
    if facts["HGMMA"] == 0 or facts["UTMALDG"] == 0 or bad or \
            len(facts["instances"]) != 3 or facts["ptxas_notes"]:
        raise AssertionError(f"{name}'s build is not the Hopper design: "
                             f"{facts}")
    return facts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import llama

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks_name, peaks = peaks_for(name)
    emit("device", nvidia_smi=smi, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peaks_from=peaks_name)
    # float32 products in full float32 for the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths = _kernels.build()   # one nvcc per source, all together
    ptxas = {}
    for src, path in paths.items():
        log = path.with_suffix(".log")
        log = log.read_text() if log.exists() else ""
        ptxas[src] = sorted({ln.split("info    :")[-1].strip()
                             for ln in log.splitlines()
                             if "Used" in ln or "spill" in ln})
    facts = {name: build_facts(_kernels, name, paths[name],
                               f"{name}_bf16_kernel")
             for name in ("flash_fwd", "flash_bwd")}
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in paths.values()], ptxas=ptxas, **facts)

    fwd_rows = check_flash(torch, peaks)
    main_case, train_case, gpt2_case = (fwd_rows[k] for k in (
        "llama3_8b", "llama3_8b_train", "gpt2_xl_train"))
    bwd_rows = check_flash_bwd(torch, peaks)
    bwd_case, bwd_gpt2_case = (bwd_rows[k] for k in (
        "llama3_8b_train", "gpt2_xl_train"))
    # the ring over an sp-4 mesh of this card at Llama-3-8B's heads, then
    # Ulysses: each with its counts zeroed right before it
    ring_counts = check_ring_kernels(torch, peaks)
    check_ulysses(torch)
    free_card(torch)

    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", config="llama3_8b", params=llama.num_params(params),
         seconds=time.perf_counter() - t0)
    # main path, each part with its counts zeroed right before it and read
    # right after: the forward, the serving engine, the gradient at depth
    # 2, then the trainer at full depth (one step under each policy)
    launches = check_model(torch, cfg, params)
    check_lm_head(torch, cfg, params)
    check_serve(torch, cfg, params)
    free_card(torch)   # the engine and its KV pool
    check_grad(torch, cfg, params)
    full_counts, attn_counts, train_losses = check_train(torch, cfg, params,
                                                         peaks)
    del params
    free_card(torch)
    # sequence parallelism and speculative decoding on fresh weights (the
    # trainer above moved these): speculative decoding (inference), the
    # gradient through the ring at depth 2, then the trainer's ring path
    # at full depth, each with its counts zeroed right before it
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", config="llama3_8b", params=llama.num_params(params),
         seconds=time.perf_counter() - t0)
    spec_counts = check_speculative(torch, cfg, params)
    free_card(torch)
    mesh = sp_mesh(torch)
    ring_grad_counts = check_ring_grad(torch, cfg, params, mesh)
    free_card(torch)
    ring_train_counts = check_ring_train(torch, cfg, params, peaks, mesh)
    del params
    free_card(torch)
    # the state placed across ranks (slice 7), every place on this card:
    # the placement of the full-depth state, the fsdp_tp gradient at
    # depth 2, the 1F1B gradient at depth 4 and the GPipe forward at full
    # depth on fresh weights; then the fsdp_tp and pp_fsdp trainers at
    # full depth, each from its own init_state, each with its counts
    # zeroed right before each step
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", config="llama3_8b", params=llama.num_params(params),
         seconds=time.perf_counter() - t0)
    check_placement(torch, cfg, params)
    free_card(torch)
    placed_grad_counts = check_placed_grad(torch, cfg, params)
    free_card(torch)
    pp_grad_counts = check_pp_grad(torch, cfg, params)
    free_card(torch)
    gpipe_counts = check_gpipe(torch, cfg, params)
    del params
    free_card(torch)
    L = cfg.n_layers
    fsdp_tp_counts = check_placed_train(
        torch, cfg, peaks, name="fsdp_tp", axes=PLACED_AXES,
        strategy="fsdp_tp", b=2, steps=3,
        want={"flash_fwd": 2 * L * 4, "flash_bwd": L * 4},
        fused_loss=True, loss_chunk=1024)
    free_card(torch)
    pp_counts = check_placed_train(
        torch, cfg, peaks, name="pp_fsdp", axes={"pp": PP_STAGES},
        strategy="pp_fsdp", b=8, steps=3,
        want={"flash_fwd": 3 * L * 4, "flash_bwd": L * 4},
        n_microbatches=4)
    free_card(torch)
    # the multi-process harness (slice 8), the card freed before each
    # phase; the parent holds no model while ranks run: Llama-3-8B through
    # TorchMeshTrainer on one NCCL rank, two gloo ranks on this card at
    # depth 4, then ElasticTrainer's reform at depth 2
    t0 = time.perf_counter()
    harness_nccl_counts = check_harness_nccl(torch, cfg, peaks, train_losses,
                                             full_counts)
    free_card(torch)
    harness_gloo_counts = check_harness_gloo(torch, cfg, peaks)
    free_card(torch)
    elastic_counts = check_elastic(torch, cfg)
    emit("harness_phases", seconds=time.perf_counter() - t0)
    # the other families, each at full width, one after another on the
    # card's memory (Mixtral at reduced depth)
    gpt_counts = check_gpt(torch, peaks)
    free_card(torch)
    bert_counts = check_bert(torch, peaks)
    vit_counts = check_vit(torch)
    mixtral_counts = check_mixtral(torch, peaks)

    by_path = {k: {"forward": launches if k == "flash_fwd" else 0,
                   "train_step_full": full_counts[k],
                   "train_step_attn": attn_counts[k],
                   "gpt2_xl_forward": gpt_counts["forward"][k],
                   "gpt2_xl_train_step_full":
                       gpt_counts["train_step_full"][k],
                   "bert_large_train_step": bert_counts["train_step"][k],
                   "vit_l16_step": vit_counts["steps"][k],
                   "mixtral_forward": mixtral_counts["forward"][k],
                   "mixtral_grad": mixtral_counts["grad"][k],
                   "ring_fwd_bwd_causal_sp4": ring_counts["causal"][k],
                   "ring_fwd_bwd_noncausal_sp4": ring_counts["noncausal"][k],
                   "ring_grad_depth2": ring_grad_counts[k],
                   "ring_train_step_full_sp4": ring_train_counts[k],
                   "speculative_self_draft": spec_counts["self"][k],
                   "speculative_depth2_draft": spec_counts["depth2"][k],
                   "fsdp_tp_grad_depth2": placed_grad_counts[k],
                   "pp_fsdp_1f1b_grad_depth4": pp_grad_counts[k],
                   "gpipe_forward_pp4": gpipe_counts[k],
                   "fsdp_tp_train_step_full": fsdp_tp_counts[k],
                   "pp_fsdp_train_step_full": pp_counts[k],
                   "harness_nccl_rank_3_steps": harness_nccl_counts[k],
                   "harness_gloo_dp2_rank0_6_steps": harness_gloo_counts[k],
                   "elastic_step_after_reform": elastic_counts[k]}
               for k in full_counts}
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:55",
        "launches": full_counts["flash_fwd"],
        "launches_by_path": by_path["flash_fwd"],
        "max_abs_err": main_case["max_err"], "tol": main_case["tol"],
        "row_rel_err": main_case["row_rel_err"],
        "row_rel_tol": main_case["row_rel_tol"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "tflops": main_case["tflops"],
        # b 2, s 2048, with lse: the shape of the training step's launches
        "train_shape": {k: train_case[k] for k in (
            "shape", "kernel_ms", "library_ms", "bound_ms", "bound_by",
            "tflops", "max_err", "row_rel_err", "lse_err")},
        # b 8, s 1024, 25 heads, no GQA, d 64, with lse: GPT-2 XL's step
        "gpt2_xl_shape": {k: gpt2_case[k] for k in (
            "shape", "kernel_ms", "library_ms", "bound_ms", "bound_by",
            "tflops", "max_err", "row_rel_err", "lse_err")},
        # non-causal with lse at an sp-4 chunk of 8K: a ring step off the
        # diagonal; d 256; a tp-2 rank of the fsdp_tp trainer
        **{f"{case}_shape": {k: fwd_rows[case][k] for k in (
            "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops", "max_err", "row_rel_err", "lse_err")}
           for case in ("ring_chunk_noncausal_lse", "d256_gqa2",
                        "llama3_8b_tp2")},
        "sass": {k: facts["flash_fwd"][k] for k in ("HGMMA", "UTMALDG")},
    }]
    # K2 and K3 are one fused kernel: each TPU kernel keeps its entry,
    # both with the fused kernel's one launch count and time
    errs, abs_errs = bwd_case["row_rel_err"], bwd_case["max_abs_err"]
    for line, other, outs in ((181, 224, ("dq",)), (224, 181, ("dk", "dv"))):
        kernels.append({
            "name": "flash_bwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "shares_launch_with": f"ray_tpu/ops/flash_attention.py:{other}",
            "outputs": list(outs),
            "launches": full_counts["flash_bwd"],
            "launches_by_path": by_path["flash_bwd"],
            "max_abs_err": max(abs_errs[o] for o in outs),
            "row_rel_err": max(errs[o] for o in outs),
            "row_rel_tol": bwd_case["row_rel_tol"],
            "ms": bwd_case["kernel_ms"], "plain_ms": bwd_case["plain_ms"],
            "bound_ms": bwd_case["bound_ms"],
            "bound_by": bwd_case["bound_by"],
            # SDPA's whole backward (dQ, dK and dV) in one call
            "library_ms": bwd_case["library_ms"],
            "tflops": bwd_case["tflops"],
            **{f"{label}_shape": {
                "shape": row["shape"],
                "row_rel_err": max(row["row_rel_err"][o] for o in outs),
                **{k: row[k] for k in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "tflops")}}
               for label, row in (("gpt2_xl", bwd_gpt2_case),
                                  ("ring_step_noncausal",
                                   bwd_rows["llama3_8b_noncausal"]),
                                  ("tp2_rank", bwd_rows["llama3_8b_tp2"]))},
            "sass": {k: facts["flash_bwd"][k] for k in ("HGMMA", "UTMALDG")},
        })
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
