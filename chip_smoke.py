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
trainer taking steps on the full 32-layer model. Every phase prints one
JSON line; the last line is the contract line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and that line is never printed. Without a CUDA card, or
without the rest of the repository beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# Datasheet peaks by card name: (dense bf16 FLOP/s, float32 FLOP/s outside
# the tensor cores, device memory bytes/s). H100 SXM and PCIe data sheets.
PEAKS = {
    "H100 80GB HBM3": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise ValueError(f"no datasheet peaks for {name!r}: add the card to "
                     "PEAKS to work out bound_ms")


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
    """||a - b|| / ||b|| over all elements, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


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


def check_flash_controls(torch, qt, kt, vt, want, tol):
    """Show that K1's tolerance tells a right kernel from a subtly wrong
    one at the main shape: attention rounded at other points (float32
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
    emit("kernel_check_controls", row_rel_tol=tol, row_rel_err=errs)


def check_flash(torch, peaks):
    """Hold the flash kernel against its plain version. Returns the main
    path's case (the Llama-3-8B attention shape, no lse) and the training
    step's (b 2, with lse)."""
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
        # the training step's shape: b 2, with lse
        ("llama3_8b_train", 2, 32, 8, 2048, 2048, 128, torch.bfloat16, True,
         True),
        ("d64_gqa1", 2, 8, 8, 1024, 1024, 64, torch.bfloat16, True, True),
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
    main = None
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
        if main is None:
            check_flash_controls(torch, qt, kt, vt, want, row_tol[dt])
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
        if main is None:
            main = row
        if name == "llama3_8b_train":
            train = row
        del q, k, v, qt, kt, vt, kr, vr, want, want_lse, got
    return main, train


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


def backward_bound(b, h, hk, s, d, itemsize, peaks):
    """The least time for the fused backward (K2 and K3) over the causal
    pairs on this card: its 5 products (S, dP, dV, dK, dQ) at the dtype's
    peak, or its compulsory bytes at the memory rate: q, k, v, out, dO and
    lse read once (delta = rowsum(dO * O) is computed inside from out and
    dO), dq, dk and dv written once."""
    pairs = float(np.minimum(np.arange(s) + 1, s).sum())
    flops = 5 * 2.0 * b * h * d * pairs
    # q, out, dO in and dq out; k, v in and dk, dv out; lse in
    nbytes = itemsize * (4 * b * h * s * d + 4 * b * hk * s * d) \
        + 4 * b * h * s
    bf16_peak, f32_peak, mem_rate = peaks
    peak = bf16_peak if itemsize == 2 else f32_peak
    t_ops, t_bytes = flops / peak, nbytes / mem_rate
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def check_flash_bwd_controls(torch, qt, kt, vt, dot, lse, delta, want,
                             tol):
    """Show that the backward's tolerance tells right gradients from subtly
    wrong ones at the main shape: gradients with float32 P and dS pass
    it; dS through float8 e4m3, the diagonal kv tile missing for the later
    half of the rows, and dK/dV summed over the first q head of each group
    only each fail it."""
    kw = dict(scale=qt.shape[-1] ** -0.5)
    variants = {
        "float32_p_and_ds": ({}, True),
        "ds_float8_e4m3": (dict(round_ds=lambda x: x.to(
            torch.float8_e4m3fn).float()), False),
        "diag_tile_dropped_late_rows": (dict(
            drop_diag_from=qt.shape[2] // 2), False),
        "dkv_first_q_head_only": (dict(first_head_only=True), False),
    }
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
    emit("flash_bwd_controls", row_rel_tol=tol, row_rel_err=errs)


def check_flash_bwd(torch, peaks):
    """Hold the fused backward (K2 and K3 in one kernel, through
    ``flash_bwd``) against K2's and K3's plain versions. At the main shape
    it runs the backward a second time: dK and dV, summed in registers,
    must come out bitwise equal, and dQ, summed across CTAs in a float32
    buffer in an order that changes from run to run, within the limit of
    the first run; then it is timed. Returns the main shape's row (b 2,
    s 2048, h 32, hk 8, d 128, bf16, causal: the shape the training step
    gives it)."""
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
        ("d64_gqa1", 2, 8, 8, 1024, 64, torch.bfloat16, True),
        ("d256_gqa2", 1, 4, 2, 1024, 256, torch.bfloat16, True),
        ("f32_small", 1, 4, 2, 384, 128, torch.float32, True),
        ("f32_ragged_d256", 1, 2, 1, 200, 256, torch.float32, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    main = None
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
        if main is None:
            check_flash_bwd_controls(torch, qt, kt, vt, dot, lse, delta,
                                     want, row_tol[dt])
        row = dict(case=name, shape=[b, h, hk, s, s, d], dtype=str(dt),
                   causal=causal, row_rel_err=errs, row_rel_tol=row_tol[dt],
                   max_abs_err=abs_errs)
        if main is None:
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

            # timed at the main shape only (the others are checks): by
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
                b, h, hk, s, d, qt.element_size(), peaks)
            row.update(bound_ms=bound_ms, bound_by=bound_by,
                       gflop=flops / 1e9, mbytes=nbytes / 1e6,
                       tflops=flops / (row["kernel_ms"] * 1e-3) / 1e12)
            main = row
            del q, k, v
        emit("flash_bwd_check", **row)
        del qt, kt, vt, dot, out, lse, delta, args, got, want
    return main


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


def check_model(torch, cfg, params) -> int:
    """The full forward through the flash kernel against the same forward
    with reference attention. Returns the flash kernel's launches in the
    timed forward, read right after it."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_fwd

    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 2048)).astype(np.int64)).cuda()
    llama.forward(cfg, params, tokens)          # warm-up, not counted
    torch.cuda.synchronize()
    flash_fwd.launches = 0
    t0 = time.perf_counter()
    logits = llama.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = flash_fwd.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"one forward, expected {cfg.n_layers}")
    if logits.shape != (1, 2048, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    t0 = time.perf_counter()
    ref = llama.forward(cfg, params, tokens, attn_impl="reference")
    torch.cuda.synchronize()
    reference_s = time.perf_counter() - t0
    # one forward with attention fed float8-rounded inputs: what a lower
    # precision than bf16-in / f32-accumulate does to the same logits
    orig = llama.attention
    llama.attention = fp8_rounded_attention
    try:
        low = llama.forward(cfg, params, tokens)
    finally:
        llama.attention = orig
    # Both forwards are bf16 models that differ only in attention's
    # rounding points (the kernel rounds unnormalized probabilities to
    # bf16, the reference normalized ones); over 32 layers that leaves a
    # relative RMS logit error of order 1e-2. The tolerance sits below the
    # float8 variant's error, so a lower-precision attention fails it.
    tol = 5e-2
    err = rel_rms(logits, ref)
    err_low = rel_rms(low, ref)
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    emit("model", config="llama3_8b", n_layers=cfg.n_layers, seq=2048,
         flash_launches=launches, forward_s=forward_s,
         reference_forward_s=reference_s, logits_rel_rms_err=err, tol=tol,
         fp8_attention_rel_rms_err=err_low, argmax_agreement=agree,
         max_abs_err=float((logits - ref).abs().max()))
    if not err <= tol < err_low:
        raise AssertionError(
            f"forward logits rel err {err} vs tol {tol} (float8 attention "
            f"gives {err_low}; the tolerance must sit between)")
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


def check_grad(torch, cfg, params):
    """The gradient of the training loss through the flash kernels (K1
    with lse, the fused backward) against the same gradient through reference
    attention, at full width and depth 2, on [2, 2049] tokens. The
    control: the same loss with q detached before attention (the fault of
    a forward with no gradient) must fail the tolerance."""
    import dataclasses

    from ray_tpu_torch.models import llama

    depth = 2
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    # the first two layers, as leaves that share the full model's storage
    params2 = {k: ({n: w[:depth].detach() for n, w in v.items()}
                   if k == "blocks" else v.detach())
               for k, v in params.items()}
    names, leaves = zip(*named_leaves(params2))
    for t in leaves:
        t.requires_grad_(True)
    batch = train_batch(cfg, 2, 2048, SEED + 3)

    def grads(attn_impl):
        hidden = llama.forward_hidden(cfg2, params2, batch[:, :-1],
                                      attn_impl=attn_impl)
        loss = llama.fused_cross_entropy(cfg2, params2, hidden, batch[:, 1:],
                                         chunk=1024)
        # the detached-q control leaves wq without a gradient: zeros
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True)

    zero_counts()
    loss, got = grads("auto")
    torch.cuda.synchronize()
    counts = launch_counts()
    want_counts = {"flash_fwd": 2 * depth,
                   "flash_bwd": depth}   # remat "full": K1 reruns
    if counts != want_counts:
        raise AssertionError(f"launches in one gradient {counts}, expected "
                             f"{want_counts}")
    ref_loss, want = grads("reference")
    orig = llama.attention
    llama.attention = lambda q, k, v, **kw: orig(q.detach(), k, v, **kw)
    try:
        _, bad = grads("auto")
    finally:
        llama.attention = orig
    # bf16 model: the two attentions round at other points (the kernels
    # round P and dS to bf16, the reference its normalized probabilities),
    # and that reaches every gradient through the residual stream
    tol = 5e-2
    errs = {n: rel_rms(g, w) for n, g, w in zip(names, got, want)}
    bad_errs = {n: rel_rms(g, w) for n, g, w in zip(names, bad, want)}
    emit("grad", config="llama3_8b", n_layers=depth, tokens=[2, 2049],
         loss=float(loss.detach()), reference_loss=float(ref_loss.detach()),
         launches=counts, rel_rms_err=errs, tol=tol,
         q_detached_rel_rms_err=bad_errs)
    if max(errs.values()) > tol or max(bad_errs.values()) <= tol:
        raise AssertionError(
            f"gradient rel err {errs} vs tol {tol}; the detached-q control "
            f"must exceed it: {bad_errs}")
    for t in leaves:
        t.requires_grad_(False)


def check_train(torch, cfg, params, peaks):
    """The trainer on llama3_8b() at full width and depth, bf16, with the
    fused loss: 6 steps on one repeated [2, 2049] batch, then one step
    under remat "attn". Returns the launch counts of one step under each
    policy."""
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
    pairs = s * (s + 1) // 2
    flops = 6.0 * n_matmul * b * s + \
        12.0 * L * b * cfg.n_heads * cfg.head_dim * pairs
    emit("train", config="llama3_8b", n_layers=L, depth_cut=None,
         tokens=[b, s + 1], remat=cfg.remat, fused_loss=True,
         loss_chunk=1024, steps=steps, losses=losses, grad_norms=norms,
         step_s=times, median_step_s=step_s, tokens_per_s=b * s / step_s,
         flops_per_step=flops, mfu=flops / step_s / peaks[0],
         peak_memory_bytes=peak_bytes, state_bytes=state_bytes,
         launches_full=full_counts, launches_attn=attn_counts,
         attn_step_loss=attn_loss)
    first_ok = abs(losses[0] - float(np.log(cfg.vocab_size))) < 1.0
    if not (all(np.isfinite(losses + [attn_loss])) and first_ok
            and losses[-1] < losses[1]):
        raise AssertionError(f"training losses {losses} (first should be "
                             f"near ln(vocab) {np.log(cfg.vocab_size):.2f} "
                             "and the last below the second)")
    if full_counts != want_full or attn_counts != want_attn:
        raise AssertionError(
            f"launches in one step: full {full_counts} (want {want_full}), "
            f"attn {attn_counts} (want {want_attn})")
    return full_counts, attn_counts


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

    main_case, train_case = check_flash(torch, peaks)
    bwd_case = check_flash_bwd(torch, peaks)

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
    gc.collect()   # the engine and its KV pool
    torch.cuda.empty_cache()
    check_grad(torch, cfg, params)
    full_counts, attn_counts = check_train(torch, cfg, params, peaks)

    by_path = {k: {"forward": launches if k == "flash_fwd" else 0,
                   "train_step_full": full_counts[k],
                   "train_step_attn": attn_counts[k]}
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
