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
on the card) and runs the ring and Ulysses at Llama-3-8B's heads. Then
RLlib's on-policy algorithms at the JAX package's defaults (a 64-wide
policy/value MLP; no kernel of the table runs there): PPO on CartPole-v1
for 3 iterations and on Bandit-v0 for 7, by which it must have learned
it, IMPALA and APPO for 3 iterations each, each iteration's seconds
split into sampling and learning, each with the card's update held
against the CPU's from the same parameters and batch (1e-5 relative; a
control that changes a clip must miss it), and the learner plane: mode
"mesh" on 2 places of this card against one learner, mode "actors" on 2
gloo rank processes of this card against mode "mesh". Then RLlib's
replay and offline algorithms at their defaults: DQN on CartPole-v1 and
SAC, TD3 and DDPG on Pendulum-v1 for 3 iterations each (the last two
update), one update each of double DQN, dueling, C51 and prioritized
3-step replay, SAC, TD3 and DDPG held against the CPU's (1e-5 relative,
each with a control), and their learning checks on the bandits; BC, CQL
and MARWIL from a dataset collected into a temporary directory, each
update against the CPU's. Then it drives
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
steps). The tensor-parallel paths run on {fsdp 2, tp 2} of this card:
Llama-3-8B's gradient and steps with the vocabulary cut over tp through
the loss, GPT-2 XL at full depth (its gradient at depth 2 against the
one-card trainer's, then steps) and BERT-large's steps through the hook;
Mixtral's depth-16 forward over a tree placed by ``moe`` on {fsdp 2,
ep 2, tp 2} against the one-place forward. Then the multi-process train
harness, each phase spawning rank
processes over torch.distributed: Llama-3-8B at full depth through
TorchMeshTrainer on one NCCL rank fed by the device feed (its losses
against the one-process trainer's), the same rank fed by a ``Dataset``
pipeline run in this process (the tokens stored offset, undone by a
module-level ``map_batches``, then ``sort``, ``drop_columns`` and
``repartition``; control: the pipeline without the undoing map), two
ranks on this card over gloo at
depth 1 (their parameters and gradient norms against the
single-controller trainer on {dp 2}, with controls that skip the
gradient all-reduce and that average in place of the sum), and
ElasticTrainer's reform from {dp 2, fsdp 2} to {dp 2} at depth 1. Then
one spawn of four gloo rank processes on this card, each phase against
its single controller run first: fsdp, tp and sp across processes
sharing one global mesh, Llama-3-8B's width at depth 1 on {fsdp 2, tp 2}
(one place a process) and at depth 1 on {sp 4} (the ring between the
processes), with controls (the rank-list psum backward in place of
Megatron's g, a skipped fsdp reduce-scatter, the ring shifted the wrong
way); then pp and ep across processes and the elastic reform to a new
world: Llama-3-8B's width at depth 4 on {pp 4}
(a stage a process; control: gradients sent to the next stage),
Mixtral 8x7B's depth-4 forward with fsdp and ep across the processes
(control: the experts' outputs from the wrong ep process), and a save at
world 4 on {fsdp 2, tp 2} that two survivors restore onto {fsdp 2} bit
for bit before a step (control: a restore one row off). Then Tune: a
``Tuner`` with population-based training over the learning rate, four
trials of Llama-3-8B's widths at depth 1, two at a time, each one NCCL
rank process on this card (an exploited trial's first loss against its
donor's at that step; control: the restore skipped), the serve body
``LLMDeployment`` on the full model's weights (its greedy tokens bit for
bit against the paged engine's, and again under a replica context; a
burst of 16 requests on its one engine), then Serve on the port's
in-process runtime: ``serve.run`` of two ``LLMDeployment`` replicas over
those weights behind an ingress deployment, the ten prompts through the
handle and one through the HTTP proxy bit for bit the engine's, prefix
affinity (the holder of a shared prefix takes every request carrying it;
control: a first page changed), the burst across the replicas, and the
card's memory back after the phase; then the cluster runtime, a
``Cluster`` of one node {CPU 8, GPU 1} with this process attached by
``init(address=)``: K1 in a worker process bit for bit this process's
(control: the non-causal output), a 1 GiB bf16 tensor of the card through
``put`` and a worker's ``get`` and back, two full-depth Llama-3-8B
``LLMDeployment`` replicas, each in its own process and building its own
weights from the seed (checksums against this process's), the ten
prompts bit for bit through the handle and over HTTP, the burst across
the two processes, and after shutdown no worker left and the card's free
memory back; then the CLI's cluster: a node started by ``python -m
ray_tpu_torch.scripts.cli start --head --num-gpus 1`` (its ``status`` and
``list nodes`` read), K1 in a worker forked from the node's prestart
template (the template holding no torch, no CUDA and no libcuda; the
output bit for bit this process's), a JSON config deployed by the CLI's
``serve-deploy`` (Llama-3-8B at full depth behind a bare ASGI app
mounted by ``serve.ingress``) answering prompts over HTTP bit for bit,
a fault-injected crash of its replica answered with the typed error and
the replica replaced from a fork, then no worker or template left and
the card's free memory back; Ray Data batch inference: seeded token rows
through ``ray_tpu_torch.data.from_numpy(...).map_batches(...,
compute="actors")`` on the in-process runtime over the full model's
weights, each row's greedy next token and log-probability bit for bit
the direct forward's (controls: a second weight seed, a row shifted),
the card's memory back after; and the quickstarts (the data pipeline's
rows JAX's). Every
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
import shutil
import signal
import subprocess
import sys
import threading
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


# this process's start: every phase line carries its seconds since then
_T0 = time.perf_counter()


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - _T0}), flush=True)


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


def timed_once(fn) -> tuple:
    """``fn()``'s result and its device milliseconds: one call between two
    CUDA events (a plain version's reference call, timed as it runs)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
        # slice 16: a tp-4 place of xproc_tp4 (two rows, 8 q and 2 kv
        # heads); the ring of xproc_sp2_tp2 (a process's 4096-token chunk
        # of 8K, its two tp places' heads in one ring: all 32 and 8) on
        # the diagonal and off it; a tp-2 place of Mixtral's {ep 4, tp 2}
        # forward (two rows, 16 and 4 heads, no lse)
        ("llama3_8b_tp4", 2, 8, 2, 2048, 2048, 128, torch.bfloat16, True,
         True),
        ("sp2_chunk_causal_lse", 1, 32, 8, 4096, 4096, 128, torch.bfloat16,
         True, True),
        ("sp2_chunk_noncausal_lse", 1, 32, 8, 4096, 4096, 128,
         torch.bfloat16, False, True),
        ("mixtral_ep4_tp2", 2, 16, 4, 2048, 2048, 128, torch.bfloat16, True,
         False),
        ("d64_gqa1", 2, 8, 8, 1024, 1024, 64, torch.bfloat16, True, True),
        # GPT-2 XL's training step: an odd head count, a group of one
        ("gpt2_xl_train", 8, 25, 25, 1024, 1024, 64, torch.bfloat16, True,
         True),
        # GPT-2 XL's tp-2 ranks at fsdp 2 (tp_gpt): four rows a data rank,
        # its 25 heads as 13 and 12
        ("gpt2_xl_tp2_13", 4, 13, 13, 1024, 1024, 64, torch.bfloat16, True,
         True),
        ("gpt2_xl_tp2_12", 4, 12, 12, 1024, 1024, 64, torch.bfloat16, True,
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
            qt, kt, vt, scale=scale, causal=causal, with_lse=with_lse), 1)
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
    timed, as are the non-causal case (b 1, s 2048, h 32, hk 8, d 128: a
    ring step off the diagonal) and the tp-2 ranks' shapes of Llama-3-8B
    and GPT-2 XL. Returns the timed rows by name: the main
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
        # slice 16: xproc_tp4's place, xproc_sp2_tp2's ring chunk
        ("llama3_8b_tp4", 2, 8, 2, 2048, 128, torch.bfloat16, True),
        ("sp2_chunk_causal", 1, 32, 8, 4096, 128, torch.bfloat16, True),
        ("sp2_chunk_noncausal", 1, 32, 8, 4096, 128, torch.bfloat16, False),
        ("d64_gqa1", 2, 8, 8, 1024, 64, torch.bfloat16, True),
        ("gpt2_xl_train", 8, 25, 25, 1024, 64, torch.bfloat16, True),
        ("gpt2_xl_tp2_13", 4, 13, 13, 1024, 64, torch.bfloat16, True),
        ("gpt2_xl_tp2_12", 4, 12, 12, 1024, 64, torch.bfloat16, True),
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
        # delta as the kernel sums it (float64, rounded to float32); the
        # plain version's time is this reference call's

        def plain():
            dl = flash_bwd_delta(out, dot)
            return (flash_bwd_dq_plain(qt, kt, vt, dot, lse, dl, **kw),
                    *flash_bwd_dkv_plain(qt, kt, vt, dot, lse, dl, **kw)), dl
        (want, delta), plain_ms = timed_once(plain)
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
        is_timed = with_controls or name in (
            "llama3_8b_noncausal", "llama3_8b_tp2", "gpt2_xl_tp2_13",
            "gpt2_xl_tp2_12", "llama3_8b_tp4", "sp2_chunk_causal",
            "sp2_chunk_noncausal")
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
            row["kernel_ms"] = cuda_graph_ms(kernel, 10)
            row["kernel_loop_ms"] = cuda_ms(kernel, 10)
            row["plain_ms"] = plain_ms
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
        del qt, kt, vt, dot, out, lse, delta, got, want
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

    new_tokens = 32
    prompts, shared, tails = serve_prompts(cfg)
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
    flash_fwd.launches = flash_fwd.causal_launches = flash_bwd.launches = 0


def causal_split():
    """K1's launches since the counts were zeroed, causal and not, as its
    wrapper counts them where it launches the kernel."""
    from ray_tpu_torch.ops.flash_attention import flash_fwd
    return {"flash_fwd_causal": flash_fwd.causal_launches,
            "flash_fwd_noncausal":
                flash_fwd.launches - flash_fwd.causal_launches}


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
    each data rank one row, each tp rank 16 q and 4 kv heads and half the
    vocabulary, the head never gathered over tp) against the one-card
    gradient, at full width and depth 2 on [2, 2049], remat ``full``, the
    fused loss. Controls: a tp block without the psum after wo, fsdp
    gathers along a weight's rows with two chunks swapped (a swap in every
    gather permutes the model dimension alike in every weight, which the
    function cannot see), and the vocab-parallel loss without the exp-sum
    over the tp ranks."""
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
    def swapped(xs, gather_axis=0, **kwargs):
        xs = list(xs)
        if gather_axis == 0:
            xs[0], xs[1] = xs[1], xs[0]
        return collectives.all_gather(xs, gather_axis=gather_axis, **kwargs)
    controls = {}
    for name, attr, fault in (
            ("no_psum_after_wo", "reduce_attention", lambda parts: parts),
            ("fsdp_row_gather_chunks_swapped", "all_gather", swapped),
            ("exp_sum_not_psummed_over_tp", "reduce_vocab",
             lambda parts: parts)):
        orig = getattr(spmd, attr)
        setattr(spmd, attr, fault)
        try:
            controls[name] = dict(named_leaves(
                placed.loss_and_grads(params2, batch)[1]))
        finally:
            setattr(spmd, attr, orig)
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
# depth 1 since slice 20 (2 since slice 18, 4 before), and one step a
# case at the schedule's peak (two before, the first at a learning rate of
# 0; see XPROC_STEPS), to keep the script inside its time limit as the
# later groups join it
GLOO_DEPTH = 1
GLOO_STEPS = 1
# the gloo ranks are killed after this long, from their spawn (the
# reference and check_elastic run here while they start)
GLOO_LIMIT_S = 600.0
ELASTIC_DEPTH = 1


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
    for each case of ``GLOO_CASES`` (the controls, then the real one: the
    process's start-up lands in a control's step).
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

    def mean(self, grads, group=None):
        real(self, grads, group)
        for g in grads:
            g.div_(self.world_size)
    # this rank's work: 6 FLOPs a parameter a token of its rows
    session.set_flops_per_step(6.0 * config["n_params"] * batch.numel()
                               / ctx.world_size)
    for case in (*GLOO_CASES[1:], GLOO_CASES[0]):
        trainer = Trainer(config["model_config"], config["train_config"],
                          device=ctx.device, process_group=pg)
        state = trainer.init_state(seed=SEED)
        if case == "skip_all_reduce":
            ProcessGroup.all_reduce_grads = \
                lambda self, grads, group=None: None
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


def check_harness_gloo(torch, cfg, peaks, meanwhile=None):
    """Two ranks on this one card over gloo (CUDA tensors staged through
    pinned host memory), llama3_8b() at full width and depth GLOO_DEPTH on a
    {"dp": 2} global mesh, global batch [2, 2049], GLOO_STEPS steps at
    the schedule's peak. Held: rank 0's
    parameters and gradient norms against the single-controller trainer
    on a {"dp": 2} mesh of the card; the
    ranks' parameters equal each other (check_same in the ranks). The
    controls, ranks that skip the gradient all-reduce and ranks that
    average in place of the sum, must each break a bound. The ranks start
    up (``xproc_after_go``) while the single controller and then
    ``meanwhile()`` (``check_elastic``) run here. Returns rank 0's launch
    counts (three cases, GLOO_STEPS steps each) and ``meanwhile``'s
    result."""
    import dataclasses
    import tempfile

    from ray_tpu_torch.parallel.sharding import ShardedTensor
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    b, s, steps, world = 2, 2048, GLOO_STEPS, 2
    cfg4 = dataclasses.replace(cfg, n_layers=GLOO_DEPTH)
    train_cfg = TrainConfig(mesh_axes={"dp": world}, fused_loss=True,
                            loss_chunk=1024, warmup_steps=XPROC_WARMUP)
    batch = train_batch(cfg, b, s, SEED + 17)
    box = {}

    def host(params):
        return {n: (t.unshard() if isinstance(t, ShardedTensor) else t)
                .detach().cpu() for n, t in named_leaves(params)}

    def reference_then_go(fit, deadline):
        """While the ranks start: the single controller, ``meanwhile``,
        then the ranks' go."""
        t0 = time.perf_counter()
        trainer = Trainer(cfg4, train_cfg)
        state = trainer.init_state(seed=SEED)
        box["init"] = host(state.params)
        box["losses"], box["norms"] = [], []
        for _ in range(steps):
            state, m = trainer.train_step(state, batch)
            box["losses"].append(float(m["loss"]))
            box["norms"].append(float(m["grad_norm"]))
        box["ref"] = host(state.params)
        del state, trainer
        free_card(torch)
        box["reference_s"] = time.perf_counter() - t0
        if meanwhile is not None:
            box["meanwhile"] = meanwhile()
            free_card(torch)
        zero_counts()
        xproc_go(torch, d, {
            "model_config": cfg4, "train_config": train_cfg,
            "batch": batch.cpu().numpy(), "steps": steps,
            "n_params": sum(t.numel() for t in box["init"].values())})
        box["go_s"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        result, fit_s = xproc_spawn(torch, "harness_gloo_dp2", None, None,
                                    None, None, d, loop=xproc_after_go,
                                    world=world, limit_s=GLOO_LIMIT_S,
                                    while_running=reference_then_go,
                                    then=gloo_rank_loop,
                                    go_within_s=GLOO_LIMIT_S)
        waited = xproc_waited(d, world)
        init, ref = box.pop("init"), box.pop("ref")
        ref_losses, ref_norms = box["losses"], box["norms"]
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
         reference_s=box["reference_s"], go_after_s=box["go_s"],
         ranks_waited_for_go_s=waited, fit_s=fit_s, compare_s=compare_s,
         spawn_to_first_report_s=result.first_report_s,
         go_to_first_report_s=None if result.first_report_s is None
         else result.first_report_s - box["go_s"])
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
    return per_rank[0]["launches"], box.get("meanwhile")


def elastic_axes(n: int) -> dict:
    return {"dp": 2, "fsdp": n // 2} if n > 2 else {"dp": n}


def check_elastic(torch, cfg):
    """``ElasticTrainer`` on llama3_8b() at full width and depth
    ELASTIC_DEPTH: 2
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


# ---------------------------------------------------------------------------
# fsdp, tp and sp across processes (slice 10): four gloo rank processes on
# this card share one global mesh, one place a process; each phase holds
# them against its single-controller counterpart run here first, on the
# same weights (every process initialises from the same seed) and batch
# ---------------------------------------------------------------------------

XPROC_WORLD = 4
# depth 1 since slice 20 (2 since slice 11, 4 before), so that the script
# stays inside its time limit as the later slices' phases join it (it took
# 1405.9 s at depth 2 on one host of an H100 80GB HBM3 at 700 W)
XPROC_FSDP_TP_DEPTH = 1
XPROC_SP_DEPTH = 1
# One step at the schedule's peak (XPROC_WARMUP 0) since slice 20, for the
# time limit (each step's gloo collectives take 1-10 s): Adam's first
# update, lr·g/|g| and the weight decay, as the second of the two steps
# before it, whose first ran at a learning rate of 0 on the same batch.
# What a second step adds, the moments carried across steps, the CPU tests
# hold against JAX across processes (tests/test_torch_cross_process*.py),
# and here xproc_elastic's step after its reform, which reads the moments
# its survivors restored from XPROC_ELASTIC_STEPS steps (2 before slice
# 20).
XPROC_STEPS = 1
XPROC_WARMUP = 0
XPROC_ELASTIC_STEPS = 1
# a phase's ranks are killed after this long (their fit takes about 40 s
# on an H100 80GB HBM3 at 700 W)
XPROC_LIMIT_S = 240.0
# the cases of a rank: each control (one step), then the real one
# (XPROC_STEPS steps: the process's start-up lands in a control's step),
# with the bound a control must leave: the gradient norm's
# (HARNESS_NORM_TOL) or some leaf's first moment's (XPROC_MOMENT_TOL)
XPROC_CASES = {"xproc_fsdp_tp": ("real", "psum_backward",
                                 "skip_reduce_scatter", "norm_unreduced"),
               "xproc_sp4": ("real",),
               "xproc_pp": ("real", "backward_to_next_stage"),
               # slice 16, two processes: an axis cut at the boundary
               "xproc_fsdp4": ("real", "local_split_reversed"),
               "xproc_tp4": ("real", "local_sum_skipped"),
               "xproc_sp2_tp2": ("real",),
               "xproc_sp4_w2": ("real",),
               "xproc_pp4_w2": ("real", "backward_to_next_stage")}
XPROC_CONTROL_BREAKS = {"psum_backward": "grad_norm",
                        "skip_reduce_scatter": "grad_norm",
                        "norm_unreduced": "first_moment",
                        "backward_to_next_stage": "grad_norm",
                        # a permutation of gradient pieces keeps the norm
                        "local_split_reversed": "first_moment",
                        "local_sum_skipped": "first_moment"}
# the phases whose ranks run the ring alone first (``xproc_ring_check``):
# phase -> (the global mesh, the control that must fail the output bound)
XPROC_RING = {"xproc_sp4": ({"sp": 4}, "reversed_ring"),
              "xproc_sp2_tp2": ({"sp": 2, "tp": 2}, "ring_held"),
              "xproc_sp4_w2": ({"sp": 4}, "boundary_reversed")}
# Each leaf's first moment (the gradients' running mean, bf16) after the
# ranks' steps against the single controller's: the RMS of the difference
# over the RMS of the reference, leaf by leaf. The norm weights' bf16
# update (lr against 1.0) rounds away in two steps, so only this reads a
# fault confined to them, which the global norm hardly sees. Runs on an
# H100 80GB HBM3 at 700 W read at most 1.1e-2 (fsdp_tp) and 4.9e-3 (sp 4),
# about twice the single controller's own rerun (PERF.md, section 6); a
# gradient summed over half its processes reads 0.5 or more.
XPROC_MOMENT_TOL = 5e-2


@contextlib.contextmanager
def xproc_control(case: str):
    """The faults of the cross-process step, patched in for a case:
    ``psum_backward`` (the rank-list psum's backward, an all-reduce, at the
    exits of the tp regions in place of ``g``'s identity: each process's
    replica of the sum carries the gradient on, so it is counted once a
    tp process), ``skip_reduce_scatter`` (the fsdp gathers keep their
    piece of the gradient, unsummed over the data processes),
    ``norm_unreduced`` (the same for the norm weights alone: the gathers
    of 1-d pieces), ``reversed_ring`` (K/V shifted the wrong way
    round), ``backward_to_next_stage`` (the 1F1B's gradients sent to
    stage s+1 in place of s-1) and ``experts_from_wrong_ep`` (the
    experts' outputs taken from the other ep process); over an axis cut
    at the process boundary (slice 16) ``local_sum_skipped`` (a
    process's first chunk alone in the subgroup's all-reduce),
    ``local_split_reversed`` (a process's block of a reduce-scatter
    handed to its places in reverse order), ``boundary_reversed`` (the
    ring's K/V sent across each process boundary the wrong way, the
    moves inside a process as they are) and ``ring_held`` (K/V kept in
    their process: no ring step crosses a process)."""
    import torch

    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel import pipeline, ring_attention
    from ray_tpu_torch.train import spmd

    saved = {(spmd, "tp_exit"): spmd.tp_exit,
             (spmd, "all_gather"): spmd.all_gather,
             (spmd, "gather_experts"): spmd.gather_experts,
             (pipeline, "backward_peer"): pipeline.backward_peer,
             (ring_attention, "ring_shift"): ring_attention.ring_shift,
             (col, "local_sum"): col.local_sum,
             (col, "local_split"): col.local_split}
    if case == "psum_backward":
        spmd.tp_exit = lambda xs, group: col.psum(xs, group=group)
    elif case in ("skip_reduce_scatter", "norm_unreduced"):
        def gather(xs, gather_axis=0, tiled=True, group=None):
            if group is None or (case == "norm_unreduced"
                                 and xs[0].dim() > 1):
                return col.all_gather(xs, gather_axis=gather_axis,
                                      tiled=tiled, group=group)
            return col.gather_from_group(xs, gather_axis=gather_axis,
                                         tiled=tiled, group=group)
        spmd.all_gather = gather
    elif case == "reversed_ring":
        ring_attention.ring_shift = lambda xs, shift=1, group=None: \
            col.ring_shift(xs, shift=-shift, group=group)
    elif case == "backward_to_next_stage":
        pipeline.backward_peer = lambda s, n: (s + 1) % n
    elif case == "experts_from_wrong_ep":
        gather = spmd.gather_experts

        def wrong_ep(xs, **kw):
            out = gather(xs, **kw)[0]
            n = kw["group"].size if "group" in kw else len(xs)
            return [torch.cat(out.chunk(n)[::-1])]
        spmd.gather_experts = wrong_ep
    elif case == "local_sum_skipped":
        col.local_sum = lambda xs: xs[0]
    elif case == "local_split_reversed":
        split = col.local_split
        col.local_split = lambda x, k, dim, tiled: \
            split(x, k, dim, tiled)[::-1]
    elif case == "boundary_reversed":
        def shift(xs, shift=1, group=None):
            n, k = col.axis_size(xs, group=group), len(xs)
            perm = [(i, (i + shift) % n) for i in range(n)]
            return col.ppermute(xs, [(d, s) if s // k != d // k else (s, d)
                                     for s, d in perm], group=group)
        ring_attention.ring_shift = shift
    elif case == "ring_held":
        ring_attention.ring_shift = lambda xs, shift=1, group=None: xs
    try:
        yield
    finally:
        for (module, attr), value in saved.items():
            setattr(module, attr, value)


def ring_seeded(torch):
    """Seeded q, k, v and dO at RING_SHAPE on the card, bf16 (the same in
    every process: one generator seed on one device)."""
    b, s, h, hk, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    return [torch.randn(shape, generator=gen, device="cuda")
            .to(torch.bfloat16) for shape in ((b, s, h, d), (b, s, hk, d),
                                              (b, s, hk, d), (b, s, h, d))]


def xproc_ring_check(torch, pg, out_dir, axes: dict, control: str):
    """A rank of a ring phase (``XPROC_RING``): ``ring_attention(impl=
    "flash")`` across the processes of the global mesh ``axes`` on this
    rank's chunk of the seeded RING_SHAPE inputs (its ring ranks' run of
    the sequence, all heads: the rings of its other places run as one),
    causal, and its gradients; then the same under ``control``. Saves
    both to ``<out>/ring_rank<r>.pt``; returns the launches of the real
    one, causal and not."""
    import math

    from ray_tpu_torch.parallel import ring_attention as ra
    from ray_tpu_torch.parallel.mesh import Mesh, create_mesh
    from ray_tpu_torch.parallel.process_group import mesh_layout

    layout = mesh_layout(pg, axes)
    local = create_mesh(layout.local, devices=[pg.device] * math.prod(
        layout.local.values()))
    mesh = Mesh(local.devices, local.axis_names, layout)
    chunk = RING_SHAPE[1] // axes["sp"]
    lo = mesh.offset("sp") * chunk
    hi = lo + mesh.local_shape["sp"] * chunk
    q, k, v, do = (x[:, lo:hi] for x in ring_seeded(torch))
    saved = {}
    for case in ("real", control):
        leaves = tuple(x.detach().clone().requires_grad_() for x in (q, k, v))
        with xproc_control(case):
            zero_counts()
            out = ra.ring_attention(*leaves, mesh=mesh, causal=True,
                                    impl="flash")
            grads = torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            counts = {**launch_counts(), **causal_split()}
        saved[case] = {"out": out.detach().cpu(),
                       **{f"d{n}": g.cpu() for n, g in zip("qkv", grads)}}
        if case == "real":
            real_counts = counts
    torch.save(saved, os.path.join(out_dir, f"ring_rank{pg.rank}.pt"))
    return real_counts


def xproc_ring_errs(torch, d: str, world: int, control: str) -> dict:
    """The ranks' ring outputs and gradients (``xproc_ring_check``'s
    files in ``d``, joined along the sequence in rank order) against the
    whole-sequence kernels on the same seeded inputs, row by row: the
    real ring's and the control's."""
    from ray_tpu_torch.ops.flash_attention import flash_attention

    rings = [torch.load(os.path.join(d, f"ring_rank{r}.pt"),
                        weights_only=True) for r in range(world)]
    q, k, v, do = ring_seeded(torch)
    leaves = tuple(x.requires_grad_() for x in (q, k, v))
    want = flash_attention(*leaves, causal=True)
    want_grads = torch.autograd.grad(want, leaves, do)
    errs = {}
    for case in ("real", control):
        got = {n: torch.cat([r[case][n] for r in rings], dim=1).cuda()
               for n in ("out", "dq", "dk", "dv")}
        errs[case] = {"out": row_rel_err(got["out"], want.detach()),
                      **{f"d{n}": grad_row_err(got[f"d{n}"], w)
                         for n, w in zip("qkv", want_grads)}}
        del got
    del q, k, v, do, leaves, want, want_grads, rings
    free_card(torch)
    return errs


def xproc_chunks(tree) -> dict:
    """(name, index range) -> this rank's chunk of each leaf of ``tree``,
    on the card."""
    from ray_tpu_torch.parallel.sharding import ShardedTensor

    out = {}
    for name, st in named_leaves(tree):
        if isinstance(st, ShardedTensor):
            idx = st.sharding.indices(st.shape)
            out.update({(name, tuple((s.start, s.stop)
                                     for s in idx[place])): c.detach()
                        for place, c in st.distinct()})
        else:
            out[name, tuple((0, n) for n in st.shape)] = st.detach()
    return out


def xproc_save(pg, out_dir: str, case: str, trees: dict,
               check: bool) -> None:
    """Each tree's chunks that no lower rank of ``pg`` holds, to the host
    and ``<out_dir>/<case>_rank<r>.pt``; with ``check``, the replicas of
    every range first checked equal across the processes
    (``check_same``)."""
    import torch

    held = {t: xproc_chunks(tree) for t, tree in trees.items()}
    every = pg.all_gather_object({t: sorted(c) for t, c in held.items()})
    lower = {(t, key) for other in every[:pg.rank]
             for t, keys in other.items() for key in keys}
    if check:
        pg.check_same([(f"{t}.{name}{key}", c) for t, cs in held.items()
                       for (name, key), c in cs.items()])
    out = {t: {} for t in held}
    for t, cs in held.items():
        for (name, key), c in cs.items():
            if (t, (name, key)) not in lower:
                out[t].setdefault(name, {})[key] = c.cpu()
    torch.save(out, os.path.join(out_dir, f"{case}_rank{pg.rank}.pt"))


def xproc_rank_loop(config):
    """A rank of an xproc phase: ``Trainer`` over the rank's process group
    on the global mesh ``config["train_config"].mesh_axes``, from
    ``init_state(seed)`` (the rank's chunks), for each case of
    ``XPROC_CASES[phase]``, the controls first: a control one step, the
    real one ``XPROC_STEPS`` steps. Reports each step (its seconds, each collective kind's seconds
    and bytes, the launches, the ring's K1 split). After the real case it
    saves its chunks of the parameters and the first moment by index
    range to ``<out>/<case>_rank<r>.pt``, and after a control held by the
    first moment its chunks of that (XPROC_CONTROL_BREAKS): each
    range by the lowest rank that holds it, once the real case's replicas
    of a range are checked equal across processes (``check_same``).
    Under a ring phase (``XPROC_RING``) the ring check runs first."""
    import torch

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.trainer import Trainer

    def save(case, trees):
        xproc_save(pg, config["out"], case, trees, check=case == "real")

    ctx = session.get_context()
    pg = ctx.process_group
    phase = config["phase"]
    batch = torch.from_numpy(config["batch"]).to(ctx.device)
    session.set_flops_per_step(config["rank_flops"])
    ring = xproc_ring_check(torch, pg, config["out"], *XPROC_RING[phase]) \
        if phase in XPROC_RING else None
    reports = []
    for case in (*XPROC_CASES[phase][1:], "real"):
        with xproc_control(case):
            trainer = Trainer(config["model_config"], config["train_config"],
                              device=ctx.device, process_group=pg)
            state = trainer.init_state(seed=SEED)
            torch.cuda.reset_peak_memory_stats()
            for _ in range(XPROC_STEPS if case == "real" else 1):
                before = dict(pg.stats)
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, batch)
                loss = float(m["loss"])
                step_s = time.perf_counter() - t0
                reports.append({
                    "case": case, "rank": ctx.rank, "loss": loss,
                    "grad_norm": float(m["grad_norm"]), "step_s": step_s,
                    "launches": {**launch_counts(), **causal_split()},
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                    "collectives": {k: pg.stats[k] - before[k]
                                    for k in pg.stats},
                    "ring_launches": ring})
                session.report({"case": case, "loss": loss})
        if case == "real":
            save(case, {"params": state.params, "mu": state.opt_state["mu"]})
        elif XPROC_CONTROL_BREAKS[case] == "first_moment":
            save(case, {"mu": state.opt_state["mu"]})
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(config["out"], f"steps_rank{ctx.rank}.json"),
              "w") as f:
        json.dump(reports, f)


def xproc_chunk_err(torch, ranks: list, ref: dict,
                    init: dict | None = None) -> dict:
    """The ranks' chunks (``ranks``: each a dict name -> index range ->
    tensor, each range once) against the single controller's leaves
    ``ref``: the RMS of their difference over the RMS of ``ref - init``
    (the update; ``init`` None: of ``ref`` itself), in all (``rel_err``)
    and for each leaf (``by_leaf``: its own ratio, None where its
    denominator is 0, and its share of the squared difference in all;
    ``worst_leaf`` has the largest ratio, ``largest_share_leaf`` carries
    the most). Each range's arithmetic runs on the card."""
    num, den = {}, {}
    for chunks in ranks:
        for name, pieces in chunks.items():
            for key, got in pieces.items():
                idx = tuple(slice(a, b) for a, b in key)
                r = ref[name][idx].cuda().float()
                base = r if init is None else \
                    r - init[name][idx].cuda().float()
                num[name] = num.get(name, 0.0) + float(
                    (got.cuda().float() - r).square().sum(
                        dtype=torch.float64))
                den[name] = den.get(name, 0.0) + float(
                    base.square().sum(dtype=torch.float64))
    total = sum(num.values())
    by_leaf = {n: {"rel_err": (num[n] / den[n]) ** 0.5 if den[n] else None,
                   "share": num[n] / total if total else 0.0} for n in num}
    return {"rel_err": (total / sum(den.values())) ** 0.5,
            "by_leaf": by_leaf,
            "worst_leaf": max(by_leaf, key=lambda n:
                              by_leaf[n]["rel_err"] or 0.0),
            "largest_share_leaf": max(by_leaf,
                                      key=lambda n: by_leaf[n]["share"])}


def as_rank_chunks(leaves: dict) -> list:
    """Whole leaves as one rank's chunks, each leaf one range."""
    return [{n: {tuple((0, k) for k in t.shape): t} for n, t in
             leaves.items()}]


def xproc_single_controller(torch, cfg, train_cfg, batch, mesh=None):
    """The single-controller counterpart on this card: ``Trainer`` on the
    same global mesh, every place here, from ``init_state(seed)``,
    ``XPROC_STEPS`` steps; then all again, both states held on the card,
    for the rerun against the first run (``xproc_chunk_err`` of the
    update and the first moment: the card's own run-to-run noise).
    Returns the first run's losses, gradient norms and step seconds, host
    copies of its parameters before, of its first moment after one step
    (the controls take one) and of its parameters and first moment
    after, and the rerun's comparison and gradient norms."""
    from ray_tpu_torch.parallel.sharding import ShardedTensor
    from ray_tpu_torch.train.trainer import Trainer

    def leaves(tree):
        return {n: (t.unshard() if isinstance(t, ShardedTensor) else t)
                .detach() for n, t in named_leaves(tree)}

    def host(tree):
        return {n: t.cpu() for n, t in leaves(tree).items()}

    t0 = time.perf_counter()
    out, states = {}, []
    for run in range(2):
        trainer = Trainer(cfg, train_cfg, mesh=mesh)
        state = trainer.init_state(seed=SEED)
        if run == 0:
            out["init"] = host(state.params)
        losses, norms, times = [], [], []
        for i in range(XPROC_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t1)
            norms.append(float(m["grad_norm"]))
            if run == 0 and i == 0:
                out["mu_step1"] = host(state.opt_state["mu"])
        out.update({"losses": losses, "grad_norms": norms, "step_s": times}
                   if run == 0 else {"rerun_grad_norms": norms})
        states.append(state)
        del state, trainer
    first, again = states
    del states
    out["rerun"] = {
        "update": xproc_chunk_err(torch, as_rank_chunks(leaves(
            again.params)), leaves(first.params), out["init"]),
        "first_moment": xproc_chunk_err(torch, as_rank_chunks(leaves(
            again.opt_state["mu"])), leaves(first.opt_state["mu"]))}
    del again
    free_card(torch)
    out["ref"], out["ref_mu"] = host(first.params), \
        host(first.opt_state["mu"])
    del first
    free_card(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


def xproc_compare(torch, d: str, phase: str, single: dict,
                  world: int = XPROC_WORLD, case: str = "real") -> dict:
    """The ranks' saved chunks (``<d>/<case>_rank<r>.pt``) against the
    single controller's leaves (``xproc_chunk_err``): the real case's
    update and first moment (the gradients' running mean: the norm
    weights' bf16 update rounds away in two steps, their moment does
    not), beside the single controller's rerun against its first run,
    leaf by leaf; the first moment of each control held by it after its
    one step. Returns the emitted fields."""
    def load(case):
        return [torch.load(os.path.join(d, f"{case}_rank{r}.pt"),
                           weights_only=True) for r in range(world)]

    def fields(err):
        return {"rel_err": err["rel_err"], "by_leaf": err["by_leaf"],
                "worst_leaf": err["worst_leaf"],
                "largest_share_leaf": err["largest_share_leaf"]}

    real = load(case)
    out = {
        "update": fields(xproc_chunk_err(
            torch, [r["params"] for r in real], single["ref"],
            single["init"])),
        "first_moment": fields(xproc_chunk_err(
            torch, [r["mu"] for r in real], single["ref_mu"])),
        "single_controller_rerun": {
            **{t: fields(e) for t, e in single["rerun"].items()},
            "grad_norms": single["rerun_grad_norms"]}}
    del real
    out["controls_first_moment"] = {
        case: fields(xproc_chunk_err(
            torch, [r["mu"] for r in load(case)], single["mu_step1"]))
        for case in XPROC_CASES.get(phase, ())[1:]
        if XPROC_CONTROL_BREAKS[case] == "first_moment"}
    return out


def worst_moment(fields: dict) -> float:
    """The largest leaf's first-moment ratio of ``xproc_compare``'s
    fields."""
    return max(v["rel_err"] or 0.0 for v in fields["by_leaf"].values())


def xproc_spawn(torch, phase, cfg, train_cfg, batch, rank_flops, out,
                loop=None, world=XPROC_WORLD, limit_s=XPROC_LIMIT_S,
                while_running=None, **extra):
    """The phase's ranks: ``world`` gloo processes on this card running
    ``loop`` (default ``xproc_rank_loop``) on the phase's config (and
    ``extra``), joined within ``limit_s`` (on expiry every rank is
    killed and the phase fails); their result. ``while_running(fit,
    deadline)`` runs here while they do (``fit``: the thread that joins
    them); if it raises, every rank is killed."""
    import multiprocessing
    import threading

    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.train.data_parallel_trainer import \
        DataParallelTrainer

    t0 = time.perf_counter()
    trainer = DataParallelTrainer(
        loop or xproc_rank_loop,
        train_loop_config={"phase": phase, "model_config": cfg,
                           "train_config": train_cfg,
                           "batch": None if batch is None else
                           batch.cpu().numpy(),
                           "rank_flops": rank_flops, "out": out, **extra},
        scaling_config=ScalingConfig(num_workers=world, use_gpu=True,
                                     backend="gloo"),
        run_config=RunConfig(storage_path=out))
    box = {}
    fit = threading.Thread(target=lambda: box.update(result=trainer.fit()),
                           daemon=True)
    fit.start()
    if while_running is not None:
        try:
            while_running(fit, t0 + limit_s)
        except BaseException:
            for child in multiprocessing.active_children():
                child.kill()
            raise
    fit.join(max(0.0, t0 + limit_s - time.perf_counter()))
    if fit.is_alive():
        for child in multiprocessing.active_children():
            child.kill()
        raise AssertionError(f"{phase}: the ranks did not finish within "
                             f"{limit_s} s; killed")
    if "result" not in box:
        raise AssertionError(f"{phase}: fit() raised (see above)")
    result = box["result"]
    if result.error is not None:
        raise AssertionError(f"{phase} failed:\n{result.error}")
    return result, time.perf_counter() - t0


def xproc_after_go(config):
    """A rank of a spawn started before the parent's work that its config
    waits on (the phases' single controllers, a reference run), so that
    its start-up (20-56 s a spawn) overlaps that work: it waits for
    ``<out>/go`` (``xproc_go``), writes its seconds of waiting to
    ``<out>/waited_rank<r>`` (0: the parent was ready first), then runs
    ``config["then"]`` (``xproc_world4_loop``, ``xproc_cut_loop``,
    ``gloo_rank_loop``) on its config and the go file's keys."""
    import torch

    from ray_tpu_torch.train import session

    go = os.path.join(config["out"], "go")
    t0 = time.monotonic()
    while not os.path.exists(go):
        if time.monotonic() - t0 > config["go_within_s"]:
            raise TimeoutError(f"no {go} within {config['go_within_s']} s")
        time.sleep(0.1)
    rank = session.get_context().rank
    with open(os.path.join(config["out"], f"waited_rank{rank}"), "w") as f:
        json.dump({"seconds": time.monotonic() - t0}, f)
    config["then"]({**config, **torch.load(go, weights_only=False)})


def xproc_go(torch, d: str, keys: dict) -> None:
    """The ranks' config keys (``phases``: each phase's config) to
    ``<d>/go`` for the ranks waiting in ``xproc_after_go`` (written under
    another name, then renamed)."""
    tmp = os.path.join(d, ".go.tmp")
    torch.save(keys, tmp)
    os.replace(tmp, os.path.join(d, "go"))


def xproc_waited(d: str, world: int) -> list:
    """Each rank's seconds of waiting for its go (``xproc_after_go``)."""
    out = []
    for r in range(world):
        with open(os.path.join(d, f"waited_rank{r}")) as f:
            out.append(json.load(f)["seconds"])
    return out


def xproc_steps(out: str, world: int = XPROC_WORLD) -> list:
    """Every rank's step reports (each rank writes its own: only rank 0's
    stream reaches the harness's result), rank order."""
    steps = []
    for r in range(world):
        with open(os.path.join(out, f"steps_rank{r}.json")) as f:
            steps += json.load(f)
    return steps


def xproc_summary(steps: list) -> dict:
    """Per rank, its real steps: seconds, each collective kind's seconds
    and bytes (the kinds that ran), launches, peak memory."""
    from ray_tpu_torch.parallel.process_group import KINDS

    out = {}
    for r in steps:
        if r["case"] != "real":
            continue
        c = r["collectives"]
        kinds = {k: {"calls": c[f"{k}_calls"], "s": c[f"{k}_s"],
                     "bytes": c[f"{k}_bytes"]} for k in KINDS
                 if c[f"{k}_calls"]}
        if c["grad_all_reduces"]:
            kinds["grad_all_reduce"] = {"calls": c["grad_all_reduces"],
                                        "s": c["grad_all_reduce_s"],
                                        "bytes": c["grad_bytes"]}
        out.setdefault(r["rank"], []).append({
            "step_s": r["step_s"], "loss": r["loss"],
            "grad_norm": r["grad_norm"], "launches": r["launches"],
            "peak_memory_bytes": r["peak_memory_bytes"],
            "staging_s": c["staging_s"], "staged_bytes": c["staged_bytes"],
            "collectives": kinds})
    return out


def xproc_norm_errs(steps: list, ref_norms: list) -> dict:
    """Each case's largest gradient-norm error against the single
    controller's, relative, over ranks and steps."""
    errs, seen = {}, {}
    for r in steps:
        i = seen.get((r["case"], r["rank"]), 0)
        seen[r["case"], r["rank"]] = i + 1
        errs[r["case"]] = max(errs.get(r["case"], 0.0),
                              abs(r["grad_norm"] / ref_norms[i] - 1.0))
    return errs


def xproc_fsdp_tp_setup(torch, cfg) -> dict:
    """xproc_fsdp_tp's single controller (``check_xproc_fsdp_tp``) and
    its ranks' config for the shared spawn."""
    import dataclasses

    from ray_tpu_torch.train.trainer import TrainConfig

    b, s, L = 2, 2048, XPROC_FSDP_TP_DEPTH
    cfg4 = dataclasses.replace(cfg, n_layers=L)
    train_cfg = TrainConfig(mesh_axes=dict(PLACED_AXES), strategy="fsdp_tp",
                            fused_loss=True, loss_chunk=1024,
                            warmup_steps=XPROC_WARMUP)
    batch = train_batch(cfg, b, s, SEED + 23)
    single = xproc_single_controller(torch, cfg4, train_cfg, batch)
    n_matmul = sum(single["init"][f"blocks.{k}"].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + single["init"]["lm_head"].numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    return {"b": b, "s": s, "L": L, "single": single, "flops": flops,
            "rank": {"model_config": cfg4, "train_config": train_cfg,
                     "batch": batch.cpu().numpy(),
                     "rank_flops": flops / XPROC_WORLD}}


def check_xproc_fsdp_tp(torch, cfg, peaks, setup: dict, d: str,
                        spawn: dict):
    """``llama3_8b()`` at full width and depth XPROC_FSDP_TP_DEPTH on the
    global mesh {fsdp 2, tp 2} under fsdp_tp, dealt to four gloo rank
    processes on this card, one place each: each rank its data row of
    the global [2, 2049] batch, 16 q and 4 kv heads, half the vocabulary
    through the fused vocab-parallel loss. Held after XPROC_STEPS steps:
    every rank's chunks against the single-controller trainer's on the
    same mesh of this card (slice 7's path), run first, within
    HARNESS_PARAM_TOL of its update, every leaf's first moment within
    XPROC_MOMENT_TOL of its own, and every rank's gradient norms within
    HARNESS_NORM_TOL. In its one step each control must break its bound
    (XPROC_CONTROL_BREAKS): the norm's for the rank-list psum backward in
    place of the f/g pair and for the fsdp gathers' reduce-scatter
    skipped, a leaf's first moment's for that skip on the norm weights
    alone. Every real step's launches per rank: K1 2·L (all causal) and the
    backward L. Its ranks run in the shared spawn (``check_xproc_world4``,
    ``spawn``: each phase's seconds in the ranks), their files in ``d``.
    Returns rank 0's launches of one real step."""
    b, s, L = setup["b"], setup["s"], setup["L"]
    single, flops = setup["single"], setup["flops"]
    t0 = time.perf_counter()
    cmp = xproc_compare(torch, d, "xproc_fsdp_tp", single)
    compare_s = time.perf_counter() - t0
    steps = xproc_steps(d)
    update_rel_err = cmp["update"]["rel_err"]
    moment_err = worst_moment(cmp["first_moment"])
    norm_errs = xproc_norm_errs(steps, single["grad_norms"])
    controls = {}
    for c in XPROC_CASES["xproc_fsdp_tp"][1:]:
        controls[c] = {"grad_norm_rel_err": norm_errs[c],
                       "must_break": XPROC_CONTROL_BREAKS[c]}
        if XPROC_CONTROL_BREAKS[c] == "grad_norm":
            controls[c]["broke"] = norm_errs[c] > HARNESS_NORM_TOL
        else:
            fields = cmp["controls_first_moment"][c]
            controls[c].update(
                first_moment=fields,
                first_moment_worst_leaf_rel_err=worst_moment(fields),
                broke=worst_moment(fields) > XPROC_MOMENT_TOL)
    per_rank = xproc_summary(steps)
    want = {"flash_fwd": 2 * L, "flash_bwd": L, "flash_fwd_causal": 2 * L,
            "flash_fwd_noncausal": 0}
    launches = {r: [st["launches"] for st in rs]
                for r, rs in per_rank.items()}
    step_s = max(st["step_s"] for rs in per_rank.values()
                 for st in rs[1:] or rs)
    emit("xproc_fsdp_tp", config="llama3_8b", n_layers=L,
         depth_cut=f"{L} of {cfg.n_layers} layers (four states' chunks and "
                   "the single controller's state on one card)",
         tokens=[b, s + 1], steps=XPROC_STEPS, backend="gloo",
         world_size=XPROC_WORLD, mesh=PLACED_AXES, strategy="fsdp_tp",
         one_place_a_process=True,
         single_controller_losses=single["losses"],
         single_controller_grad_norms=single["grad_norms"],
         single_controller_step_s=single["step_s"],
         losses=[st["loss"] for st in per_rank[0]],
         update_rel_err=update_rel_err, tol=HARNESS_PARAM_TOL,
         update=cmp["update"], first_moment_worst_leaf_rel_err=moment_err,
         moment_tol=XPROC_MOMENT_TOL, first_moment=cmp["first_moment"],
         single_controller_rerun=cmp["single_controller_rerun"],
         grad_norm_rel_err=norm_errs["real"], norm_tol=HARNESS_NORM_TOL,
         controls=controls,
         step_s=step_s, tokens_per_s=b * s / step_s,
         rank_flops_per_step=flops / XPROC_WORLD,
         mfu_of_the_card=flops / step_s / peaks[0],
         ranks=per_rank, want_launches=want,
         ranks_s=spawn["xproc_fsdp_tp"],
         single_controller_s=single["seconds"], compare_s=compare_s)
    if update_rel_err > HARNESS_PARAM_TOL or \
            moment_err > XPROC_MOMENT_TOL or \
            norm_errs["real"] > HARNESS_NORM_TOL or \
            not all(c["broke"] for c in controls.values()):
        raise AssertionError(
            f"xproc_fsdp_tp: update error {update_rel_err} (tol "
            f"{HARNESS_PARAM_TOL}), worst leaf's first moment {moment_err} "
            f"(tol {XPROC_MOMENT_TOL}), norm errors {norm_errs} (tol "
            f"{HARNESS_NORM_TOL}); each control must break its bound: "
            f"{ {c: v['broke'] for c, v in controls.items()} }")
    if any(c != want for cs in launches.values() for c in cs):
        raise AssertionError(f"xproc_fsdp_tp launches {launches}, want "
                             f"{want} a rank's step")
    return launches[0][-1]


def xproc_sp4_setup(torch, cfg) -> dict:
    """xproc_sp4's single controller (``check_xproc_sp4``) and its ranks'
    config for the shared spawn."""
    import dataclasses

    from ray_tpu_torch.train.trainer import TrainConfig

    b, s, L = 1, RING_SHAPE[1], XPROC_SP_DEPTH
    cfg2 = dataclasses.replace(cfg, n_layers=L)
    train_cfg = TrainConfig(mesh_axes={"sp": RING_SP},
                            strategy="fsdp_tp_sp", fused_loss=True,
                            loss_chunk=1024, warmup_steps=XPROC_WARMUP)
    batch = train_batch(cfg, b, s, SEED + 29)
    single = xproc_single_controller(torch, cfg2, train_cfg, batch,
                                     mesh=sp_mesh(torch))
    n_matmul = sum(single["init"][f"blocks.{k}"].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + single["init"]["lm_head"].numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    return {"b": b, "s": s, "L": L, "single": single, "flops": flops,
            "rank": {"model_config": cfg2, "train_config": train_cfg,
                     "batch": batch.cpu().numpy(),
                     "rank_flops": flops / XPROC_WORLD}}


def check_xproc_sp4(torch, cfg, peaks, setup: dict, d: str, spawn: dict):
    """``llama3_8b()`` at full width and depth XPROC_SP_DEPTH on the
    global mesh {sp 4} under fsdp_tp_sp, dealt to four gloo rank
    processes on this card: each its 2048-token chunk of [1, 8193], the
    ring between the processes (K/V by subgroup sends), the whole state
    replicated over sp and its gradient all-reduced over it. First the
    ring alone at RING_SHAPE, each rank its chunk: the output within 1e-2
    a row and the gradients within 2e-2 a row of the whole-sequence
    kernels (as ring_kernels), and the ring shifted the wrong way must
    fail the output bound. Then XPROC_STEPS trainer steps against the
    single-controller sp-4 ring trainer on this card (slice 6's path): the
    losses within HARNESS_LOSS_TOL, the update within HARNESS_PARAM_TOL,
    every leaf's first moment within XPROC_MOMENT_TOL.
    Launches a rank's step: K1 causal 2·L (the diagonal, the forward and
    its recompute) and non-causal 2·L·rank, the backward L·(rank + 1). Its
    ranks run in the shared spawn (``check_xproc_world4``), their files in
    ``d``. Returns rank 3's launches of one real step."""
    b, s, L = setup["b"], setup["s"], setup["L"]
    single, flops = setup["single"], setup["flops"]
    t0 = time.perf_counter()
    cmp = xproc_compare(torch, d, "xproc_sp4", single)
    compare_s = time.perf_counter() - t0
    steps = xproc_steps(d)
    # the ring against the whole-sequence kernels on the same inputs
    ring_errs = xproc_ring_errs(torch, d, XPROC_WORLD, "reversed_ring")
    out_tol, grad_tol = 1e-2, 2e-2
    per_rank = xproc_summary(steps)
    update_rel_err = cmp["update"]["rel_err"]
    moment_err = worst_moment(cmp["first_moment"])
    losses = [st["loss"] for st in per_rank[0]]
    loss_err = max(abs(a - w) for a, w in zip(losses, single["losses"]))
    wants = {r: {"flash_fwd": 2 * L * (r + 1), "flash_bwd": L * (r + 1),
                 "flash_fwd_causal": 2 * L, "flash_fwd_noncausal": 2 * L * r}
             for r in range(XPROC_WORLD)}
    launches = {r: [st["launches"] for st in rs]
                for r, rs in per_rank.items()}
    ring_launches = {r: next(x["ring_launches"] for x in steps
                             if x["rank"] == r) for r in range(XPROC_WORLD)}
    step_s = max(st["step_s"] for rs in per_rank.values()
                 for st in rs[1:] or rs)
    emit("xproc_sp4", config="llama3_8b", n_layers=L,
         depth_cut=f"{L} of {cfg.n_layers} layers (the state replicated "
                   "over sp: four whole states on one card)",
         tokens=[b, s + 1], chunk=s // RING_SP, steps=XPROC_STEPS,
         backend="gloo", world_size=XPROC_WORLD, mesh={"sp": RING_SP},
         strategy="fsdp_tp_sp", ring_shape=list(RING_SHAPE),
         ring_row_rel_err=ring_errs["real"], out_tol=out_tol,
         grad_tol=grad_tol,
         ring_controls={"reversed_ring": ring_errs["reversed_ring"]},
         ring_launches=ring_launches,
         single_controller_losses=single["losses"],
         single_controller_grad_norms=single["grad_norms"],
         single_controller_step_s=single["step_s"], losses=losses,
         loss_max_abs_err=loss_err, loss_tol=HARNESS_LOSS_TOL,
         update_rel_err=update_rel_err, tol=HARNESS_PARAM_TOL,
         update=cmp["update"], first_moment_worst_leaf_rel_err=moment_err,
         moment_tol=XPROC_MOMENT_TOL, first_moment=cmp["first_moment"],
         single_controller_rerun=cmp["single_controller_rerun"],
         grad_norm_rel_err=xproc_norm_errs(steps, single["grad_norms"]),
         step_s=step_s, tokens_per_s=b * s / step_s,
         rank_flops_per_step=flops / XPROC_WORLD,
         mfu_of_the_card=flops / step_s / peaks[0], ranks=per_rank,
         want_launches=wants, ranks_s=spawn["xproc_sp4"],
         single_controller_s=single["seconds"], compare_s=compare_s)
    real = ring_errs["real"]
    if real["out"] > out_tol or max(real[f"d{n}"] for n in "qkv") > \
            grad_tol or ring_errs["reversed_ring"]["out"] <= out_tol:
        raise AssertionError(f"xproc_sp4 ring: {ring_errs} (out tol "
                             f"{out_tol}, grad tol {grad_tol}; the reversed "
                             "ring must fail the out bound)")
    if loss_err > HARNESS_LOSS_TOL or update_rel_err > HARNESS_PARAM_TOL \
            or moment_err > XPROC_MOMENT_TOL:
        raise AssertionError(f"xproc_sp4: losses {losses} against "
                             f"{single['losses']} (tol {HARNESS_LOSS_TOL}), "
                             f"update error {update_rel_err} (tol "
                             f"{HARNESS_PARAM_TOL}), worst leaf's first "
                             f"moment {moment_err} (tol {XPROC_MOMENT_TOL})")
    if any(c != wants[r] for r, cs in launches.items() for c in cs):
        raise AssertionError(f"xproc_sp4 launches {launches}, want {wants}")
    return launches[XPROC_WORLD - 1][-1]


# ---------------------------------------------------------------------------
# pp and ep across processes, and the elastic reform to a new world
# (slice 11): four gloo rank processes on this card, each phase held
# against its single-controller counterpart run here first
# ---------------------------------------------------------------------------

XPROC_PP_DEPTH = PP_STAGES       # one layer a stage
XPROC_PP_MICRO = 4
# Mixtral 8x7B's width, EP_AXES dealt to the four processes: fsdp and ep
# across them, tp inside each; depth 4 since slice 20 (8 since slice 16,
# 16 before, as ep_placed_forward), to keep the script inside its time
# limit as the later slices' phases join it
XPROC_EP_DEPTH = 4
# the wrong-ep control's depth: the fault shows in the first layer
XPROC_EP_CONTROL_DEPTH = 2
# depth 1 since slice 20 (2 before), for the time limit
XPROC_ELASTIC_DEPTH = 1
XPROC_SURVIVORS = 2


def collective_share(step: dict) -> float:
    """The share of a rank's step (``xproc_summary``'s entry) in its
    collectives (every kind, the gradient all-reduce, the staging between
    their rounds is inside each)."""
    return sum(c["s"] for c in step["collectives"].values()) / step["step_s"]


def xproc_pp_setup(torch, cfg) -> dict:
    """``llama3_8b()`` at full width and depth XPROC_PP_DEPTH on the
    global mesh {pp 4} under pp_fsdp, dealt to four gloo rank processes
    on this card, one stage (one layer) a process: [8, 2049] in
    XPROC_PP_MICRO microbatches, each process running its own stage's
    slots of the 1F1B, the activations and gradients sent between the
    processes (one ``batch_isend_irecv`` a move), the io parameters
    (embedding, final norm, head) replicated in every process and their
    gradients summed over pp. Held after XPROC_STEPS steps against the
    single-controller pp_fsdp trainer on {pp 4} of this card (the
    ``pp_fsdp`` phase's path), run first: every rank's chunks within HARNESS_PARAM_TOL of its
    update, every leaf's first moment within XPROC_MOMENT_TOL of its own,
    every rank's gradient norms within HARNESS_NORM_TOL, and the io
    replicas equal across the processes (``check_same``). Control: the
    gradients sent to stage s+1 in place of s-1, which must break the
    norm's bound in its one step. Launches a rank's step: K1 12, all
    causal (4 microbatches: the forward slot, the backward slot's forward
    and its remat), the backward 4. This part runs the single controller
    and returns it, with the ranks' config; ``check_xproc_pp`` reads the
    ranks' results."""
    import dataclasses

    from ray_tpu_torch.train.trainer import TrainConfig

    t_start = time.perf_counter()
    b, s, L, m = 8, 2048, XPROC_PP_DEPTH, XPROC_PP_MICRO
    cfg4 = dataclasses.replace(cfg, n_layers=L)
    train_cfg = TrainConfig(mesh_axes={"pp": PP_STAGES}, strategy="pp_fsdp",
                            n_microbatches=m, warmup_steps=XPROC_WARMUP)
    batch = train_batch(cfg, b, s, SEED + 37)
    single = xproc_single_controller(torch, cfg4, train_cfg, batch)
    n_matmul = sum(single["init"][f"blocks.{k}"].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + single["init"]["lm_head"].numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    return {"single": single, "flops": flops, "shape": (b, s, L, m),
            "seconds": time.perf_counter() - t_start,
            "rank": {"model_config": cfg4, "train_config": train_cfg,
                     "batch": batch.cpu().numpy(),
                     "rank_flops": flops / XPROC_WORLD}}


def check_xproc_pp(torch, cfg, peaks, setup: dict, d: str,
                   spawn: dict) -> dict:
    """``xproc_pp_setup``'s phase held, from its ranks' results in ``d``
    (``spawn``: the shared spawn's times). Returns rank 0's launches of
    one real step."""
    single, flops = setup["single"], setup["flops"]
    b, s, L, m = setup["shape"]
    t0 = time.perf_counter()
    cmp = xproc_compare(torch, d, "xproc_pp", single)
    compare_s = time.perf_counter() - t0
    steps = xproc_steps(d)
    update_rel_err = cmp["update"]["rel_err"]
    moment_err = worst_moment(cmp["first_moment"])
    norm_errs = xproc_norm_errs(steps, single["grad_norms"])
    controls = {c: {"grad_norm_rel_err": norm_errs[c],
                    "must_break": XPROC_CONTROL_BREAKS[c],
                    "broke": norm_errs[c] > HARNESS_NORM_TOL}
                for c in XPROC_CASES["xproc_pp"][1:]}
    per_rank = xproc_summary(steps)
    want = {"flash_fwd": 3 * m * L // PP_STAGES,
            "flash_bwd": m * L // PP_STAGES,
            "flash_fwd_causal": 3 * m * L // PP_STAGES,
            "flash_fwd_noncausal": 0}
    launches = {r: [st["launches"] for st in rs]
                for r, rs in per_rank.items()}
    step_s = max(st["step_s"] for rs in per_rank.values()
                 for st in rs[1:] or rs)
    emit("xproc_pp", config="llama3_8b", n_layers=L,
         depth_cut=f"{L} of {cfg.n_layers} layers, one a stage (the io "
                   "parameters, their moments and gradients in every "
                   "process, and the single controller's state first)",
         tokens=[b, s + 1], microbatches=m, steps=XPROC_STEPS,
         backend="gloo", world_size=XPROC_WORLD, mesh={"pp": PP_STAGES},
         strategy="pp_fsdp", one_stage_a_process=True,
         single_controller_losses=single["losses"],
         single_controller_grad_norms=single["grad_norms"],
         single_controller_step_s=single["step_s"],
         losses=[st["loss"] for st in per_rank[0]],
         update_rel_err=update_rel_err, tol=HARNESS_PARAM_TOL,
         update=cmp["update"], first_moment_worst_leaf_rel_err=moment_err,
         moment_tol=XPROC_MOMENT_TOL, first_moment=cmp["first_moment"],
         single_controller_rerun=cmp["single_controller_rerun"],
         grad_norm_rel_err=norm_errs["real"], norm_tol=HARNESS_NORM_TOL,
         controls=controls, step_s=step_s, tokens_per_s=b * s / step_s,
         collective_share={r: [collective_share(st) for st in rs]
                           for r, rs in per_rank.items()},
         rank_flops_per_step=flops / XPROC_WORLD,
         mfu_of_the_card=flops / step_s / peaks[0],
         ranks=per_rank, want_launches=want,
         single_controller_s=single["seconds"], ranks_s=spawn["xproc_pp"],
         compare_s=compare_s,
         seconds=setup["seconds"] + spawn["xproc_pp"] + compare_s)
    if update_rel_err > HARNESS_PARAM_TOL or \
            moment_err > XPROC_MOMENT_TOL or \
            norm_errs["real"] > HARNESS_NORM_TOL or \
            not all(c["broke"] for c in controls.values()):
        raise AssertionError(
            f"xproc_pp: update error {update_rel_err} (tol "
            f"{HARNESS_PARAM_TOL}), worst leaf's first moment {moment_err} "
            f"(tol {XPROC_MOMENT_TOL}), norm errors {norm_errs} (tol "
            f"{HARNESS_NORM_TOL}); the control must break the norm's "
            f"bound: {controls}")
    if any(c != want for cs in launches.values() for c in cs):
        raise AssertionError(f"xproc_pp launches {launches}, want {want} "
                             "a rank's step")
    return launches[0][-1]


def mixtral_layer(cfg, layer: int, device) -> dict:
    """Layer ``layer`` of xproc_ep's Mixtral, drawn from a seed of its own
    (so that a process draws one layer at a time and keeps only its
    chunks): its block leaves, [1, ...] each."""
    import dataclasses

    from ray_tpu_torch.models import mixtral

    return mixtral.init_params(
        dataclasses.replace(cfg, n_layers=1, vocab_size=1),
        seed=SEED + 300 + layer, device=device)["blocks"]


def mixtral_io(cfg, device) -> dict:
    """xproc_ep's Mixtral embedding, final norm and head."""
    import dataclasses

    from ray_tpu_torch.models import mixtral

    # one layer of one-column experts beside them: the io leaves depend
    # on the vocabulary and the width alone
    params = mixtral.init_params(
        dataclasses.replace(cfg, n_layers=1, d_ff=1), seed=SEED + 299,
        device=device)
    return {k: v for k, v in params.items() if k != "blocks"}


def mixtral_layerwise(torch, cfg, device) -> dict:
    """xproc_ep's whole Mixtral tree, its layers drawn one at a time into
    the stacked leaves."""
    blocks = {}
    for layer in range(cfg.n_layers):
        for n, w in mixtral_layer(cfg, layer, device).items():
            if n not in blocks:
                blocks[n] = torch.empty((cfg.n_layers,) + tuple(w.shape[1:]),
                                        dtype=w.dtype, device=device)
            blocks[n][layer] = w[0]
    return {**mixtral_io(cfg, device), "blocks": blocks}


def mixtral_placed_layerwise(torch, cfg, mesh, rules) -> dict:
    """This process's chunks of ``mixtral_layerwise``'s tree, placed by
    ``rules`` on ``mesh`` (its places of a mesh across processes), drawn
    one layer at a time: no process holds the whole model. Places with
    one range on one device share one chunk, as ``device_put`` makes
    them."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.sharding import (ShardedTensor, device_put,
                                                 tree_shardings)

    shardings = tree_shardings(mixtral.param_logical_axes(cfg), mesh, rules)
    dev = mesh.devices.ravel()[0]
    out = {k: device_put(v, shardings[k])
           for k, v in mixtral_io(cfg, dev).items()}
    leaves = {}
    for layer in range(cfg.n_layers):
        for n, w in mixtral_layer(cfg, layer, dev).items():
            sh = shardings["blocks"][n]
            shape = (cfg.n_layers,) + tuple(w.shape[1:])
            if n not in leaves:
                made, places = {}, []
                for idx, d in zip(sh.indices(shape), mesh.devices.ravel()):
                    key = (tuple((x.start, x.stop) for x in idx), str(d))
                    if key not in made:
                        made[key] = (idx, torch.empty(
                            [x.stop - x.start for x in idx], dtype=w.dtype,
                            device=d))
                    places.append(made[key])
                leaves[n] = (shape, w.dtype, sh, places, list(made.values()))
            for idx, chunk in leaves[n][4]:
                if idx[0].start <= layer < idx[0].stop:
                    chunk[layer - idx[0].start] = w[0][idx[1:]].to(
                        chunk.device)
    out["blocks"] = {n: ShardedTensor(shape, dtype, sh,
                                      [c for _, c in places])
                     for n, (shape, dtype, sh, places, _) in leaves.items()}
    return out


def placed_first_layers(tree: dict, depth: int) -> dict:
    """The first ``depth`` layers of a placed stacked tree: views of its
    chunks, places that share a chunk sharing its view."""
    from ray_tpu_torch.parallel.sharding import ShardedTensor

    def first(st):
        views = {}
        return ShardedTensor((depth,) + tuple(st.shape[1:]), st.dtype,
                             st.sharding, [views.setdefault(id(c), c[:depth])
                                           for c in st.chunks])
    return {k: {n: first(st) for n, st in v.items()} if k == "blocks"
            else v for k, v in tree.items()}


def xproc_ep_loop(config):
    """A rank of xproc_ep (or xproc_ep4_w2): this process's places of
    ``config["axes"]`` (EP_AXES at world 4: one fsdp and one ep index,
    both tp places), its chunks of the layerwise Mixtral
    (``mixtral_placed_layerwise``), and ``spmd.placed_forward`` across the
    processes on the global [2, 2048] with the routing replayed from the
    single controller's run; then the control, the first
    XPROC_EP_CONTROL_DEPTH layers with the experts' outputs taken from the
    wrong ep process. Each forward's logit rows (this process's data row)
    against the single controller's at its depth, on the card, its aux
    loss, launches, seconds, collectives and peak memory to
    ``<out>/steps_rank<r>.json``."""
    import dataclasses
    import math

    import torch

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.mesh import Mesh, create_mesh
    from ray_tpu_torch.parallel.process_group import mesh_layout
    from ray_tpu_torch.parallel.sharding import MOE_RULES
    from ray_tpu_torch.train import session, spmd

    ctx = session.get_context()
    pg = ctx.process_group
    cfg = config["model_config"]
    layout = mesh_layout(pg, config["axes"])
    local = create_mesh(layout.local, devices=[torch.device(ctx.device)]
                        * math.prod(layout.local.values()))
    mesh = Mesh(local.devices, local.axis_names, layout)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    placed = mixtral_placed_layerwise(torch, cfg, mesh, MOE_RULES)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref = torch.load(config["reference"], map_location="cpu",
                     weights_only=True, mmap=True)
    tokens = torch.from_numpy(config["tokens"]).to(ctx.device)
    # this process's block of the rows: its run of fsdp's pieces
    per = tokens.shape[0] // mesh.shape.get("fsdp", 1)
    lo = mesh.offset("fsdp") * per
    rows = lo, lo + per * mesh.local_shape.get("fsdp", 1)
    replay = Routing()
    replay.choice = {i: torch.from_numpy(c).to(ctx.device)
                     for i, c in enumerate(config["routing"])}
    reports = []
    for case, depth in (("real", cfg.n_layers),
                        ("experts_from_wrong_ep", XPROC_EP_CONTROL_DEPTH)):
        cfg_d = dataclasses.replace(cfg, n_layers=depth)
        tree = placed if depth == cfg.n_layers else \
            placed_first_layers(placed, depth)
        want = ref[f"logits_depth{depth}"][rows[0]:rows[1]].to(ctx.device)
        before = dict(pg.stats)
        with torch.no_grad(), xproc_control(case), CallRouting(replay):
            zero_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, aux = spmd.placed_forward(mixtral, cfg_d, tree, tokens,
                                           mesh=mesh, rules=MOE_RULES,
                                           return_aux_loss=True)
            torch.cuda.synchronize()
            forward_s = time.perf_counter() - t1
            counts = {**launch_counts(), **causal_split()}
        reports.append({
            "case": case, "rank": ctx.rank, "rows": list(rows),
            "n_layers": depth, "shape": list(got.shape),
            "finite": bool(torch.isfinite(got).all()),
            "logits_rel_rms_err": rel_rms(got, want),
            "bit_equal": bool(torch.equal(got, want)),
            "logits_max_abs_err": float((got - want).abs().max()),
            "aux_loss": float(aux),
            "aux_rel_err": abs(float(aux) / ref[f"aux_depth{depth}"] - 1),
            "forward_s": forward_s, "init_s": init_s, "launches": counts,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "collectives": {k: pg.stats[k] - before[k] for k in pg.stats}})
        session.report({"case": case})
        del got, want, tree
    with open(os.path.join(config["out"], f"steps_rank{ctx.rank}.json"),
              "w") as f:
        json.dump(reports, f)


def xproc_ep_setup(torch, axes=None, depth=XPROC_EP_DEPTH) -> dict:
    """Mixtral 8x7B at full width and depth XPROC_EP_DEPTH (its layers
    drawn one at a time from seeds of their own), the forward over a tree
    placed by ``moe`` on EP_AXES {fsdp 2, ep 2, tp 2} dealt to four gloo
    rank processes on this card: fsdp and ep across the processes (each
    its data row of the global [2, 2048] and 4 of the 8 experts), tp
    inside each (16 q and 4 kv heads a place). The router's logits are
    gathered over the data processes and routed once, each process runs
    its own experts on the tokens of every data process (summed over
    fsdp) and gathers every expert's outputs over ep. Held against the
    single-process placed forward on the same mesh of this card
    (``ep_placed_forward``'s path), run first, with the routing fixed to its choices: each
    process's logit rows and the aux loss within FAMILY_FORWARD_TOL.
    Control: the experts' outputs taken from the wrong ep process, which
    must break the bound, over the first XPROC_EP_CONTROL_DEPTH layers
    against the single process's forward of those. K1 2·XPROC_EP_DEPTH a
    process's forward (2 tp places) at [1, 16, 4, 2048, 128]. This
    part runs the single process's forwards and returns their logits
    (host) and routing, with the ranks' config; ``check_xproc_ep`` reads
    the ranks' results. ``axes`` and ``depth``: another layout and depth
    (xproc_ep4_w2's)."""
    import dataclasses
    import math

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.parallel.sharding import MOE_RULES, shard_tree
    from ray_tpu_torch.train import spmd

    t_start = time.perf_counter()
    axes = axes or EP_AXES
    cfg = dataclasses.replace(mixtral.mixtral_8x7b(), n_layers=depth)
    card = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    params = mixtral_layerwise(torch, cfg, card)
    torch.cuda.synchronize()
    single_init_s = time.perf_counter() - t0
    mesh = create_mesh(axes, devices=[card] * math.prod(axes.values()))
    placed = shard_tree(params, mixtral.param_logical_axes(cfg), mesh,
                        MOE_RULES)
    tokens = train_batch(cfg, 2, 2047, SEED + 41)    # [2, 2048]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CallRouting() as recorded:
            want, want_aux = spmd.placed_forward(
                mixtral, cfg, placed, tokens, mesh=mesh, rules=MOE_RULES,
                return_aux_loss=True)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        # the control's reference: the first layers, the same routing
        with CallRouting(recorded):
            want_c, aux_c = spmd.placed_forward(
                mixtral, dataclasses.replace(
                    cfg, n_layers=XPROC_EP_CONTROL_DEPTH),
                placed_first_layers(placed, XPROC_EP_CONTROL_DEPTH), tokens,
                mesh=mesh, rules=MOE_RULES, return_aux_loss=True)
    dropped = recorded.dropped_share(cfg)
    routing = [recorded.choice[i].cpu().numpy()
               for i in range(len(recorded.choice))]
    reference = {f"logits_depth{cfg.n_layers}": want.cpu(),
                 f"aux_depth{cfg.n_layers}": float(want_aux),
                 f"logits_depth{XPROC_EP_CONTROL_DEPTH}": want_c.cpu(),
                 f"aux_depth{XPROC_EP_CONTROL_DEPTH}": float(aux_c)}
    del params, placed, want, want_c, recorded
    return {"cfg": cfg, "reference": reference, "dropped": dropped,
            "single_s": single_s, "single_init_s": single_init_s,
            "seconds": time.perf_counter() - t_start, "axes": axes,
            "rank": {"model_config": cfg, "tokens": tokens.cpu().numpy(),
                     "routing": routing, "axes": axes}}


def check_xproc_ep(torch, setup: dict, d: str, spawn: dict,
                   phase: str = "xproc_ep", world: int = XPROC_WORLD,
                   bit_equal: bool = False) -> dict:
    """``xproc_ep_setup``'s phase held, from its ranks' results in ``d``
    (``spawn``: the shared spawn's times); with ``bit_equal`` each
    process's logit rows must equal the single process's bit for bit (no
    data axis spans the processes, so no sum runs in another order).
    Returns rank 0's launches."""
    from ray_tpu_torch.parallel.mesh import split_axes

    cfg, dropped, axes = setup["cfg"], setup["dropped"], setup["axes"]
    tol = FAMILY_FORWARD_TOL
    steps = xproc_steps(d, world)
    real = [r for r in steps if r["case"] == "real"]
    control = [r for r in steps if r["case"] != "real"]
    err = max(r["logits_rel_rms_err"] for r in real)
    aux_err = max(r["aux_rel_err"] for r in real)
    bad = min(r["logits_rel_rms_err"] for r in control)
    want_counts = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd": 0,
                   "flash_fwd_causal": 2 * cfg.n_layers,
                   "flash_fwd_noncausal": 0}
    launches = {r["rank"]: r["launches"] for r in real}
    ranks = {r["rank"]: {k: r[k] for k in (
        "rows", "logits_rel_rms_err", "bit_equal", "logits_max_abs_err",
        "aux_loss", "aux_rel_err", "forward_s", "init_s", "launches",
        "peak_memory_bytes")} | {
        "collectives": {k: {"calls": r["collectives"][f"{k}_calls"],
                            "s": r["collectives"][f"{k}_s"],
                            "bytes": r["collectives"][f"{k}_bytes"]}
                        for k in ("all_gather", "all_reduce")},
        "staging_s": r["collectives"]["staging_s"]} for r in real}
    forward_s = max(r["forward_s"] for r in real)
    equal = all(r["bit_equal"] for r in real)
    emit(phase, config="mixtral_8x7b", n_layers=cfg.n_layers,
         depth_cut=f"{cfg.n_layers} of 32 layers, drawn a layer at a time",
         tokens=[2, 2048], backend="gloo", world_size=world, mesh=axes,
         local=split_axes(axes, world)[0], strategy="moe",
         routing="fixed (the single controller's)",
         capacity_dropped_share=dropped, logits_rel_rms_err=err,
         bit_equal=equal, aux_rel_err=aux_err, single_controller_aux_loss=(
             setup["reference"][f"aux_depth{cfg.n_layers}"]),
         tol=tol, controls={"experts_from_wrong_ep": {
             "n_layers": XPROC_EP_CONTROL_DEPTH,
             "logits_rel_rms_err": bad, "broke": bad > tol}},
         all_finite=all(r["finite"] for r in steps),
         forward_s=forward_s,
         collective_share=max(sum(c["s"] for c in r["collectives"].values())
                              / r["forward_s"] for r in ranks.values()),
         single_controller_forward_s=setup["single_s"],
         single_controller_init_s=setup["single_init_s"], ranks=ranks,
         want_launches=want_counts, single_controller_phase_s=setup[
             "seconds"], ranks_s=spawn[phase],
         seconds=setup["seconds"] + spawn[phase])
    rows = 2 // split_axes(axes, world)[1].get("fsdp", 1)
    if not (err <= tol < bad and aux_err <= tol) or \
            (bit_equal and not equal) or \
            not all(r["finite"] and r["shape"] == [rows, 2048, cfg.vocab_size]
                    for r in steps):
        raise AssertionError(
            f"{phase}: logits rel err {err}, aux rel err {aux_err} (tol "
            f"{tol}), bit for bit {equal} (wanted: {bit_equal}); the "
            f"wrong-ep control must exceed the tol: {bad}")
    if any(c != want_counts for c in launches.values()):
        raise AssertionError(f"{phase} launches {launches}, want "
                             f"{want_counts}")
    return launches[0]


def xproc_elastic_axes(n: int) -> dict:
    """xproc_elastic's mesh for ``n`` places: {fsdp 2, tp n/2}, {fsdp n}
    for two or fewer."""
    return {"fsdp": 2, "tp": n // 2} if n > 2 else {"fsdp": n}


def saved_leaf(tree, name: str):
    """The leaf ``name`` (dotted, ``named_leaves``'s) of a saved tree."""
    for part in name.split("."):
        tree = tree[part]
    return tree


def file_mismatches(torch, path, trees: dict) -> list:
    """The leaves of ``trees`` (placed, this process's) whose saved copy
    in this process's file ``path`` differs anywhere, bit for bit: each
    chunk by its index range, a leaf within this process whole."""
    from ray_tpu_torch.train.checkpoint import _range_key

    tree = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)["tree"]
    bad = []
    for name, st in named_leaves(trees):
        saved = saved_leaf(tree, name)
        idx = st.sharding.indices(st.shape)
        for place, c in st.distinct():
            got = saved["chunks"][_range_key(idx[place])] \
                if isinstance(saved, dict) else saved[idx[place]]
            if not torch.equal(got.to(c.device), c):
                bad.append(name)
                break
    return bad


def restored_mismatches(torch, paths, trees: dict) -> tuple:
    """The restored leaves of ``trees`` (this process's chunks) that
    differ, bit for bit, from any saved chunk of every process's file in
    ``paths`` where their ranges overlap; and the elements compared."""
    from ray_tpu_torch.train.checkpoint import _range

    saved = [torch.load(p, map_location="cpu", weights_only=True,
                        mmap=True)["tree"] for p in paths]
    bad, compared = [], 0
    for name, st in named_leaves(trees):
        idx = st.sharding.indices(st.shape)
        for place, c in st.distinct():
            mine = [(s.start, s.stop) for s in idx[place]]
            for tree in saved:
                leaf = saved_leaf(tree, name)
                pieces = leaf["chunks"].items() if isinstance(leaf, dict) \
                    else [("", leaf)]
                for key, chunk in pieces:
                    have = _range(key) or [(0, n) for n in chunk.shape]
                    lo = [max(a, b[0]) for (a, _), b in zip(mine, have)]
                    hi = [min(a, b[1]) for (_, a), b in zip(mine, have)]
                    if any(a >= z for a, z in zip(lo, hi)):
                        continue
                    got = c[tuple(slice(a - m[0], z - m[0]) for a, z, m in
                                  zip(lo, hi, mine))]
                    want = chunk[tuple(slice(a - h[0], z - h[0]) for a, z, h
                                       in zip(lo, hi, have))]
                    compared += got.numel()
                    if not torch.equal(want.to(c.device), got):
                        bad.append(name)
    return sorted(set(bad)), compared


def xproc_elastic_loop(config):
    """A rank of xproc_elastic: ``ElasticTrainer(process_group=)`` on the
    global {fsdp 2, tp 2} of four processes, XPROC_ELASTIC_STEPS steps
    from ``init_state(seed)`` and a checkpoint (each process its chunks, its
    file checked bit for bit against its state); then the first
    XPROC_SURVIVORS ranks leave this group, join a new one of their own
    (the port agreed through the old one) and ``reform`` onto {fsdp 2},
    restoring the checkpoint into their places, each restored chunk
    checked bit for bit against every saved chunk it overlaps, and take
    one more step. Writes the survivors' parameters and first moment by
    index range (``xproc_save``: ``after_rank<r>.pt``) and every rank's
    report to ``steps_rank<r>.json``."""
    import glob

    import torch

    from ray_tpu_torch.parallel.process_group import (free_port,
                                                      init_process_group)
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.elastic import ElasticTrainer
    from ray_tpu_torch.train.telemetry import run_goodput

    ctx = session.get_context()
    pg, rank = ctx.process_group, ctx.rank
    batch = torch.from_numpy(config["batch"]).to(ctx.device)
    ckpt_dir = config["checkpoint_dir"]
    run = f"xproc-elastic-rank{rank}"
    et = ElasticTrainer(config["model_config"], config["train_config"],
                        checkpoint_dir=ckpt_dir,
                        mesh_axes_fn=xproc_elastic_axes,
                        devices=[torch.device(ctx.device)],
                        checkpoint_every=XPROC_ELASTIC_STEPS, run_name=run,
                        process_group=pg)
    state = et.init_state(seed=SEED)
    report = {"rank": rank, "mesh_before": et.trainer.mesh.shape,
              "losses": [], "grad_norms": []}
    state = et.fit(state, iter([batch] * XPROC_ELASTIC_STEPS),
                   steps=XPROC_ELASTIC_STEPS,
                   on_metrics=lambda m: (report["losses"].append(m["loss"]),
                                         report["grad_norms"].append(
                                             m["grad_norm"])))
    t0 = time.perf_counter()
    et.ckpt.wait()
    report["save_wait_s"] = time.perf_counter() - t0
    report["file_bytes"] = os.path.getsize(os.path.join(
        ckpt_dir, f"{XPROC_ELASTIC_STEPS}.proc{rank}of{XPROC_WORLD}.pt"))
    trees = {"params": state.params,
             "opt_state": {k: state.opt_state[k] for k in ("mu", "nu")}}
    report["saved_step"] = state.step
    report["file_not_bit_equal"] = file_mismatches(
        torch, os.path.join(ckpt_dir, f"{XPROC_ELASTIC_STEPS}.proc{rank}"
                                      f"of{XPROC_WORLD}.pt"),
        trees)
    port = pg.all_gather_object(free_port() if rank == 0 else None)[0]
    # every process's file is on disk before a survivor restores
    pg.all_reduce(torch.zeros(1, device=ctx.device))
    report["files"] = sorted(os.path.basename(f) for f in
                             glob.glob(os.path.join(ckpt_dir, "*.pt")))
    del state, trees
    gc.collect()
    torch.cuda.empty_cache()
    if rank < XPROC_SURVIVORS:
        pg.destroy()
        new = init_process_group(
            "gloo", rank, XPROC_SURVIVORS, port,
            use_gpu=torch.device(ctx.device).type == "cuda")
        state = et.reform(process_group=new)
        event = et.reform_events[0]
        t0 = time.perf_counter()
        report["restored_not_bit_equal"], report["restored_compared"] = \
            restored_mismatches(torch, [os.path.join(
                ckpt_dir, f"{XPROC_ELASTIC_STEPS}.proc{r}of{XPROC_WORLD}.pt")
                for r in range(XPROC_WORLD)],
                {"params": state.params, "opt_state": {
                    k: state.opt_state[k] for k in ("mu", "nu")}})
        report["restore_check_s"] = time.perf_counter() - t0
        # the control: a restore that assembles every block one row off
        from ray_tpu_torch.train import checkpoint

        assemble = checkpoint._assemble
        checkpoint._assemble = lambda leaf, idx, device: assemble(
            leaf, idx, device).roll(1, 0)
        try:
            wrong = et.ckpt.restore(
                target=et.trainer.abstract_state(),
                shardings=et.trainer.state_shardings())
        finally:
            checkpoint._assemble = assemble
        report["control_rows_off_not_bit_equal"] = restored_mismatches(
            torch, [os.path.join(ckpt_dir, f"{XPROC_ELASTIC_STEPS}.proc{r}"
                                           f"of{XPROC_WORLD}.pt")
                    for r in range(XPROC_WORLD)],
            {"params": wrong.params, "opt_state": {
                k: wrong.opt_state[k] for k in ("mu", "nu")}})[0]
        del wrong
        torch.cuda.empty_cache()
        report.update(mesh_after=et.trainer.mesh.shape,
                      restored_step=event.step, reform_s=event.seconds,
                      reform_places=[event.old_devices, event.new_devices],
                      restart_bucket_s=run_goodput(run)["restart"])
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = et.trainer.train_step(state, batch)
        report.update(loss_after=float(m["loss"]),
                      grad_norm_after=float(m["grad_norm"]),
                      step_after_s=time.perf_counter() - t0,
                      launches_after={**launch_counts(), **causal_split()},
                      peak_memory_bytes=torch.cuda.max_memory_allocated(),
                      collectives=dict(new.stats))
        xproc_save(new, config["out"], "after",
                   {"params": state.params, "mu": state.opt_state["mu"]},
                   check=True)
        del state
        new.destroy()
    et.close()
    with open(os.path.join(config["out"], f"steps_rank{rank}.json"),
              "w") as f:
        json.dump(report, f)
    session.report({"done": 1})


def xproc_elastic_single(torch, cfg, kw: dict, batch) -> dict:
    """The single controller's counterpart on this card: the trainer on
    {fsdp 2, tp 2} for XPROC_ELASTIC_STEPS steps from
    ``init_state(seed)``, its state then placed on {fsdp 2} (the reform's
    mesh) and one more step. Host copies of the parameters at the reform and of the parameters and
    first moment after; the losses and norms."""
    from ray_tpu_torch.parallel.sharding import (ShardedTensor, map_trees,
                                                 place_tree)
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    def whole(tree):
        return map_trees(lambda t: t.unshard() if isinstance(
            t, ShardedTensor) else t, tree,
            is_leaf=lambda x: isinstance(x, (ShardedTensor, torch.Tensor)))

    def host(tree):
        return {n: t.detach().cpu() for n, t in named_leaves(whole(tree))}

    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainConfig(mesh_axes=xproc_elastic_axes(4), **kw))
    state = tr.init_state(seed=SEED)
    losses, norms = [], []
    for _ in range(XPROC_ELASTIC_STEPS):
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mid = TrainState(params=whole(state.params), opt_state={
        "count": state.opt_state["count"],
        "mu": whole(state.opt_state["mu"]),
        "nu": whole(state.opt_state["nu"])}, step=state.step)
    del state, tr
    free_card(torch)
    out = {"init": host(mid.params), "losses": losses, "grad_norms": norms}
    tr = Trainer(cfg, TrainConfig(mesh_axes=xproc_elastic_axes(2), **kw))
    state = place_tree(mid, tr.state_shardings())
    del mid
    state, m = tr.train_step(state, batch)
    out.update(loss_after=float(m["loss"]),
               grad_norm_after=float(m["grad_norm"]),
               ref=host(state.params), ref_mu=host(state.opt_state["mu"]),
               seconds=time.perf_counter() - t0)
    del state, tr
    free_card(torch)
    return out


def xproc_elastic_setup(torch, cfg) -> dict:
    """``ElasticTrainer(process_group=)`` on ``llama3_8b()`` at full width
    and depth XPROC_ELASTIC_DEPTH: four gloo rank processes on this card
    on {fsdp 2, tp 2} under fsdp_tp take XPROC_ELASTIC_STEPS steps on
    [2, 2049] and save (each process its chunks,
    ``<step>.proc<r>of4.pt``); two of them leave the group, join a new
    one and reform onto {fsdp 2},
    restoring the checkpoint across layouts. Held: each process's file
    bit-equal to its state, each survivor's restored chunks bit-equal to
    every saved chunk they overlap (and every element of its places
    compared), the step restored; the step after the reform against the
    single controller's (the same steps, the state placed on {fsdp 2},
    one step; run first): the update within HARNESS_PARAM_TOL, every
    leaf's first moment within XPROC_MOMENT_TOL, the gradient norm within
    HARNESS_NORM_TOL. Control: a restore that assembles every block one
    row off, which the bit-for-bit check must find unequal. Launches a
    survivor's step: K1 4 (causal) and the backward 2. This part runs
    the single controller and returns it, with the ranks' config;
    ``check_xproc_elastic`` reads the ranks' results."""
    import dataclasses

    from ray_tpu_torch.train.trainer import TrainConfig

    t_start = time.perf_counter()
    b, s, L = 2, 2048, XPROC_ELASTIC_DEPTH
    cfg2 = dataclasses.replace(cfg, n_layers=L)
    kw = dict(strategy="fsdp_tp", fused_loss=True, loss_chunk=1024,
              warmup_steps=XPROC_WARMUP)
    batch = train_batch(cfg, b, s, SEED + 43)
    single = xproc_elastic_single(torch, cfg2, kw, batch)
    return {"single": single, "shape": (b, s, L),
            "seconds": time.perf_counter() - t_start,
            "rank": {"model_config": cfg2, "batch": batch.cpu().numpy(),
                     "train_config": TrainConfig(
                         mesh_axes=xproc_elastic_axes(4), **kw)}}


def check_xproc_elastic(torch, cfg, setup: dict, d: str,
                        spawn: dict) -> dict:
    """``xproc_elastic_setup``'s phase held, from its ranks' results in
    ``d`` (``spawn``: the shared spawn's times). Returns rank 0's
    launches of the step after the reform."""
    single = setup["single"]
    b, s, L = setup["shape"]
    reports = []
    for r in range(XPROC_WORLD):
        with open(os.path.join(d, f"steps_rank{r}.json")) as f:
            reports.append(json.load(f))
    t0 = time.perf_counter()
    cmp = xproc_compare(torch, d, "xproc_elastic", {
        "ref": single["ref"], "ref_mu": single["ref_mu"],
        "init": single["init"], "rerun": {}, "rerun_grad_norms": []},
        case="after", world=XPROC_SURVIVORS)
    compare_s = time.perf_counter() - t0
    survivors = reports[:XPROC_SURVIVORS]
    update_rel_err = cmp["update"]["rel_err"]
    moment_err = worst_moment(cmp["first_moment"])
    norm_err = max(abs(r["grad_norm_after"] / single["grad_norm_after"] - 1)
                   for r in survivors)
    want = {"flash_fwd": 2 * L, "flash_bwd": L, "flash_fwd_causal": 2 * L,
            "flash_fwd_noncausal": 0}
    file_bad = {r["rank"]: r["file_not_bit_equal"] for r in reports}
    restored_bad = {r["rank"]: r["restored_not_bit_equal"]
                    for r in survivors}
    emit("xproc_elastic", config="llama3_8b", n_layers=L,
         depth_cut=f"{L} of {cfg.n_layers} layers", tokens=[b, s + 1],
         steps_before=XPROC_ELASTIC_STEPS, backend="gloo",
         world_before=XPROC_WORLD,
         world_after=XPROC_SURVIVORS,
         mesh_before=reports[0]["mesh_before"],
         mesh_after=survivors[0]["mesh_after"], strategy="fsdp_tp",
         files=reports[0]["files"],
         file_bytes={r["rank"]: r["file_bytes"] for r in reports},
         save_wait_s={r["rank"]: r["save_wait_s"] for r in reports},
         file_not_bit_equal=file_bad, restored_not_bit_equal=restored_bad,
         controls={"rows_off": {
             "not_bit_equal": {r["rank"]: r["control_rows_off_not_bit_equal"]
                               for r in survivors},
             "broke": all(r["control_rows_off_not_bit_equal"]
                          for r in survivors)}},
         restored_compared={r["rank"]: r["restored_compared"]
                            for r in survivors},
         restored_step={r["rank"]: r["restored_step"] for r in survivors},
         reform_s={r["rank"]: r["reform_s"] for r in survivors},
         restore_check_s={r["rank"]: r["restore_check_s"]
                          for r in survivors},
         restart_bucket_s={r["rank"]: r["restart_bucket_s"]
                           for r in survivors},
         losses=reports[0]["losses"],
         single_controller_losses=single["losses"],
         loss_after={r["rank"]: r["loss_after"] for r in survivors},
         single_controller_loss_after=single["loss_after"],
         update_rel_err=update_rel_err, tol=HARNESS_PARAM_TOL,
         update=cmp["update"], first_moment_worst_leaf_rel_err=moment_err,
         moment_tol=XPROC_MOMENT_TOL, first_moment=cmp["first_moment"],
         grad_norm_rel_err=norm_err, norm_tol=HARNESS_NORM_TOL,
         step_after_s={r["rank"]: r["step_after_s"] for r in survivors},
         peak_memory_bytes={r["rank"]: r["peak_memory_bytes"]
                            for r in survivors},
         launches_after={r["rank"]: r["launches_after"] for r in survivors},
         want_launches=want, single_controller_s=single["seconds"],
         ranks_s=spawn["xproc_elastic"], compare_s=compare_s,
         seconds=setup["seconds"] + spawn["xproc_elastic"] + compare_s)
    if any(file_bad.values()) or any(restored_bad.values()) or any(
            r["restored_step"] != XPROC_ELASTIC_STEPS or
            r["restored_compared"] == 0
            or not r["control_rows_off_not_bit_equal"] for r in survivors):
        raise AssertionError(f"xproc_elastic: files not bit-equal "
                             f"{file_bad}, restores not bit-equal "
                             f"{restored_bad}; the rows-off control must "
                             "be found unequal")
    if update_rel_err > HARNESS_PARAM_TOL or \
            moment_err > XPROC_MOMENT_TOL or norm_err > HARNESS_NORM_TOL:
        raise AssertionError(
            f"xproc_elastic: update error {update_rel_err} (tol "
            f"{HARNESS_PARAM_TOL}), worst leaf's first moment {moment_err} "
            f"(tol {XPROC_MOMENT_TOL}), norm error {norm_err} (tol "
            f"{HARNESS_NORM_TOL})")
    launches = {r["rank"]: r["launches_after"] for r in survivors}
    if any(c != want for c in launches.values()):
        raise AssertionError(f"xproc_elastic launches {launches}, want "
                             f"{want}")
    return launches[0]


# the four-rank phases of slices 10 and 11, in one spawn since slice 18 (a
# spawn's start-up, 24-39 s, paid once), the elastic reform last: its
# survivors leave the group
XPROC_WORLD4 = ("xproc_fsdp_tp", "xproc_sp4", "xproc_pp", "xproc_ep",
                "xproc_elastic")
# the shared spawn's ranks are killed after this long
XPROC_WORLD4_LIMIT_S = 600.0


def xproc_world4_loop(config):
    """A rank of the shared spawn: ``xproc_rank_loop`` on xproc_fsdp_tp,
    xproc_sp4 and xproc_pp, ``xproc_ep_loop`` and ``xproc_elastic_loop``
    in turn, each on its config and in a directory of its own, the card
    freed after each; then its seconds to ``<out>/done_<phase>_rank<r>``
    (the parent checks a phase while the ranks run the next)."""
    import torch

    from ray_tpu_torch.train import session

    loops = {"xproc_fsdp_tp": xproc_rank_loop, "xproc_sp4": xproc_rank_loop,
             "xproc_pp": xproc_rank_loop, "xproc_ep": xproc_ep_loop,
             "xproc_elastic": xproc_elastic_loop}
    rank = session.get_context().rank
    for phase in XPROC_WORLD4:
        t0 = time.perf_counter()
        loops[phase]({**config["phases"][phase], "phase": phase,
                      "out": os.path.join(config["out"], phase)})
        gc.collect()
        torch.cuda.empty_cache()
        mark = os.path.join(config["out"], f"done_{phase}_rank{rank}")
        with open(mark + ".tmp", "w") as f:
            json.dump({"seconds": time.perf_counter() - t0}, f)
        os.replace(mark + ".tmp", mark)


def check_xproc_world4(torch, cfg, peaks) -> dict:
    """fsdp, tp and sp across processes (slice 10), pp and ep across them
    and the elastic reform (slice 11): one spawn of four gloo ranks, which
    start up (``xproc_after_go``; a spawn costs 24-56 s of start-up) while
    each phase's single controller runs on this card
    (``xproc_fsdp_tp_setup``, ``xproc_sp4_setup``, ``xproc_pp_setup``,
    ``xproc_ep_setup``, ``xproc_elastic_setup``, the card freed after
    each); then the ranks run the five phases in turn, and each phase is
    held (``check_xproc_fsdp_tp``, ``check_xproc_sp4``,
    ``check_xproc_pp``, ``check_xproc_ep``) as soon as every rank is done
    with it, while they run the next; the elastic reform, whose survivors
    leave the group, after they end (``check_xproc_elastic``). Returns
    each phase's launches, and xproc_pp's setup (its single controller
    serves xproc_pp4_w2, the same {pp 4} at world 2)."""
    import tempfile

    t_start = time.perf_counter()
    setups, times = {}, {}
    checks = {
        "xproc_fsdp_tp": lambda out: check_xproc_fsdp_tp(
            torch, cfg, peaks, setups["xproc_fsdp_tp"], out, spawn),
        "xproc_sp4": lambda out: check_xproc_sp4(
            torch, cfg, peaks, setups["xproc_sp4"], out, spawn),
        "xproc_pp": lambda out: check_xproc_pp(
            torch, cfg, peaks, setups["xproc_pp"], out, spawn),
        "xproc_ep": lambda out: check_xproc_ep(
            torch, setups["xproc_ep"], out, spawn),
        "xproc_elastic": lambda out: check_xproc_elastic(
            torch, cfg, setups["xproc_elastic"], out, spawn)}
    counts, spawn = {}, {}

    def marks_of(phase):
        return [os.path.join(d, f"done_{phase}_rank{r}")
                for r in range(XPROC_WORLD)]

    def check(phase):
        """Phase ``phase`` held from its ranks' files, which then go."""
        for m in marks_of(phase):
            if os.path.exists(m):
                with open(m) as f:
                    spawn[phase] = max(spawn.get(phase, 0.0),
                                       json.load(f)["seconds"])
        out = os.path.join(d, phase)
        counts[phase] = checks[phase](out)
        shutil.rmtree(out)
        free_card(torch)

    def setup_then_check(fit, deadline):
        """While the ranks start: the single controllers, then the ranks'
        go; then each phase but the reform checked as soon as every rank
        is done with it, while they run the next."""
        t0 = time.perf_counter()
        for phase, setup in (("xproc_fsdp_tp",
                              lambda: xproc_fsdp_tp_setup(torch, cfg)),
                             ("xproc_sp4",
                              lambda: xproc_sp4_setup(torch, cfg)),
                             ("xproc_pp", lambda: xproc_pp_setup(torch, cfg)),
                             ("xproc_ep", lambda: xproc_ep_setup(torch)),
                             ("xproc_elastic",
                              lambda: xproc_elastic_setup(torch, cfg))):
            setups[phase] = setup()
            free_card(torch)
        times["setup_s"] = time.perf_counter() - t0
        reference = os.path.join(d, "xproc_ep", "reference.pt")
        torch.save(setups["xproc_ep"]["reference"], reference)
        phases = {p: dict(setups[p]["rank"]) for p in XPROC_WORLD4}
        phases["xproc_ep"]["reference"] = reference
        phases["xproc_elastic"]["checkpoint_dir"] = os.path.join(
            d, "xproc_elastic", "checkpoints")
        xproc_go(torch, d, {"phases": phases})
        times["go_s"] = time.perf_counter() - t0
        for phase in XPROC_WORLD4[:-1]:
            while not all(os.path.exists(m) for m in marks_of(phase)):
                if not fit.is_alive():
                    return   # the join reports the ranks' error
                if time.perf_counter() > deadline:
                    raise AssertionError(f"xproc_world4: {phase} not done "
                                         f"within {XPROC_WORLD4_LIMIT_S} s")
                time.sleep(0.5)
            check(phase)

    with tempfile.TemporaryDirectory() as d:
        for phase in XPROC_WORLD4:
            os.makedirs(os.path.join(d, phase))
        result, fit_s = xproc_spawn(torch, "world4", None, None, None,
                                    None, d, loop=xproc_after_go,
                                    limit_s=XPROC_WORLD4_LIMIT_S,
                                    while_running=setup_then_check,
                                    then=xproc_world4_loop,
                                    go_within_s=XPROC_WORLD4_LIMIT_S)
        check("xproc_elastic")
        waited = xproc_waited(d, XPROC_WORLD)
        if set(counts) != set(XPROC_WORLD4):
            raise AssertionError(f"xproc_world4: checked {sorted(counts)} "
                                 f"of {XPROC_WORLD4}")
    emit("xproc_world4", checked_while_the_ranks_ran=True,
         setup_while_the_ranks_started=True, setup_s=times["setup_s"],
         go_after_s=times["go_s"], ranks_waited_for_go_s=waited,
         fit_s=fit_s, spawn_to_first_report_s=result.first_report_s,
         go_to_first_report_s=None if result.first_report_s is None
         else result.first_report_s - times["go_s"],
         ranks_s_by_phase=spawn, seconds=time.perf_counter() - t_start)
    return counts, setups["xproc_pp"]


# ---------------------------------------------------------------------------
# Layouts whose process boundary cuts an axis, and the ring beside other
# places in a process (slice 16): two gloo rank processes on this card,
# each holding a run of consecutive indices of the cut axis (or, under
# {sp 2, tp 2}, its sp index with both tp places), each phase held
# against its single-controller counterpart run here first
# ---------------------------------------------------------------------------

XPROC_CUT_WORLD = 2
# the shared spawn's ranks are killed after this long
XPROC_CUT_LIMIT_S = 600.0
XPROC_EP_CUT_AXES = {"ep": 4, "tp": 2}
# depth 4 since slice 20 (8 before), for the time limit
XPROC_EP_CUT_DEPTH = 4
# trainer phase -> (global mesh, strategy, batch rows, sequence, depth,
# TrainConfig keywords); depth 1 since slice 20 (2 before), for the time
# limit
XPROC_CUT_TRAIN = {
    "xproc_fsdp4": ({"fsdp": 4}, "fsdp", 4, 2048, 1,
                    {"fused_loss": True, "loss_chunk": 1024}),
    "xproc_tp4": ({"tp": 4}, "fsdp_tp", 2, 2048, 1,
                  {"fused_loss": True, "loss_chunk": 1024}),
    "xproc_sp2_tp2": ({"sp": 2, "tp": 2}, "fsdp_tp_sp", 1, RING_SHAPE[1], 1,
                      {"fused_loss": True, "loss_chunk": 1024}),
    "xproc_sp4_w2": ({"sp": 4}, "fsdp_tp_sp", 1, RING_SHAPE[1], 1,
                     {"fused_loss": True, "loss_chunk": 1024}),
    "xproc_pp4_w2": ({"pp": PP_STAGES}, "pp_fsdp", 8, 2048, PP_STAGES,
                     {"n_microbatches": XPROC_PP_MICRO}),
}
XPROC_CUT = (*XPROC_CUT_TRAIN, "xproc_ep4_w2")


def xproc_cut_want(phase: str, rank: int, L: int) -> dict:
    """The launches of a rank's step in a trainer phase of XPROC_CUT (K1
    runs twice a layer, the forward and its recompute under full remat;
    the ring's diagonal is causal, the steps off it not):
    - fsdp4: two data ranks a process, each K1 2L and the backward L;
    - tp4: two tp places a process, each as one data rank;
    - sp2_tp2: one ring over both tp places' heads, this process ring
      rank ``rank``: K1 2L causal and 2L·rank not, the backward
      L·(rank + 1);
    - sp4_w2: ring ranks 2·rank and 2·rank + 1: K1 4L causal and
      2L·(4·rank + 1) not, the backward L·(4·rank + 3);
    - pp4_w2: two stages of one layer a process, each K1 3 and the
      backward 1 a microbatch."""
    m = XPROC_PP_MICRO
    causal, noncausal, bwd = {
        "xproc_fsdp4": (4 * L, 0, 2 * L),
        "xproc_tp4": (4 * L, 0, 2 * L),
        "xproc_sp2_tp2": (2 * L, 2 * L * rank, L * (rank + 1)),
        "xproc_sp4_w2": (4 * L, 2 * L * (4 * rank + 1), L * (4 * rank + 3)),
        "xproc_pp4_w2": (3 * m * 2, 0, m * 2),
    }[phase]
    return {"flash_fwd": causal + noncausal, "flash_bwd": bwd,
            "flash_fwd_causal": causal, "flash_fwd_noncausal": noncausal}


def xproc_cut_setup(torch, cfg, phase: str) -> dict:
    """A trainer phase of XPROC_CUT: ``llama3_8b()`` at full width and the
    phase's depth on its global mesh (``XPROC_CUT_TRAIN``), its single
    controller on this card first (``xproc_single_controller``: that
    mesh, every place here, run twice); returns it with the ranks'
    config."""
    import dataclasses

    from ray_tpu_torch.train.trainer import TrainConfig

    t_start = time.perf_counter()
    axes, strategy, b, s, L, kw = XPROC_CUT_TRAIN[phase]
    cfg_l = dataclasses.replace(cfg, n_layers=L)
    train_cfg = TrainConfig(mesh_axes=dict(axes), strategy=strategy,
                            warmup_steps=XPROC_WARMUP, **kw)
    batch = train_batch(cfg, b, s, SEED + 43 + len(phase))
    single = xproc_single_controller(torch, cfg_l, train_cfg, batch)
    n_matmul = sum(single["init"][f"blocks.{k}"].numel() for k in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + single["init"]["lm_head"].numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    return {"single": single, "flops": flops, "shape": (b, s, L),
            "seconds": time.perf_counter() - t_start,
            "rank": {"model_config": cfg_l, "train_config": train_cfg,
                     "batch": batch.cpu().numpy(),
                     "rank_flops": flops / XPROC_CUT_WORLD}}


def check_xproc_cut_train(torch, cfg, peaks, phase: str, setup: dict,
                          d: str, spawn: dict) -> dict:
    """A trainer phase of XPROC_CUT held, from its ranks' results in
    ``d``: every rank's chunks within HARNESS_PARAM_TOL of the single
    controller's update, every leaf's first moment within
    XPROC_MOMENT_TOL of its own, the losses within HARNESS_LOSS_TOL and
    every rank's gradient norms within HARNESS_NORM_TOL; each control must
    break its bound (XPROC_CONTROL_BREAKS) in its one step, and under a
    ring phase the ring alone must hold the whole-sequence kernels (the
    output within 1e-2 a row, the gradients 2e-2) while its control fails
    the output bound. Every real step's launches: ``xproc_cut_want``.
    Returns the phase's summary and the last rank's launches of one real
    step."""
    from ray_tpu_torch.parallel.mesh import split_axes

    single, flops = setup["single"], setup["flops"]
    b, s, L = setup["shape"]
    axes = XPROC_CUT_TRAIN[phase][0]
    world = XPROC_CUT_WORLD
    t0 = time.perf_counter()
    cmp = xproc_compare(torch, d, phase, single, world=world)
    ring_errs = xproc_ring_errs(torch, d, world, XPROC_RING[phase][1]) \
        if phase in XPROC_RING else None
    compare_s = time.perf_counter() - t0
    steps = xproc_steps(d, world)
    update_rel_err = cmp["update"]["rel_err"]
    moment_err = worst_moment(cmp["first_moment"])
    norm_errs = xproc_norm_errs(steps, single["grad_norms"])
    per_rank = xproc_summary(steps)
    losses = [st["loss"] for st in per_rank[0]]
    loss_err = max(abs(a - w) for a, w in zip(losses, single["losses"]))
    controls = {}
    for c in XPROC_CASES[phase][1:]:
        controls[c] = {"grad_norm_rel_err": norm_errs[c],
                       "must_break": XPROC_CONTROL_BREAKS[c]}
        if XPROC_CONTROL_BREAKS[c] == "grad_norm":
            controls[c]["broke"] = norm_errs[c] > HARNESS_NORM_TOL
        else:
            fields = cmp["controls_first_moment"][c]
            controls[c].update(
                first_moment_worst_leaf_rel_err=worst_moment(fields),
                worst_leaf=fields["worst_leaf"],
                broke=worst_moment(fields) > XPROC_MOMENT_TOL)
    out_tol, grad_tol = 1e-2, 2e-2
    if ring_errs is not None:
        control = XPROC_RING[phase][1]
        real = ring_errs["real"]
        controls[control] = {"ring_row_rel_err": ring_errs[control],
                             "must_break": "ring output",
                             "broke": ring_errs[control]["out"] > out_tol}
        ring_ok = real["out"] <= out_tol and \
            max(real[f"d{n}"] for n in "qkv") <= grad_tol
    else:
        ring_ok = True
    wants = {r: xproc_cut_want(phase, r, L) for r in range(world)}
    launches = {r: [st["launches"] for st in rs]
                for r, rs in per_rank.items()}
    step_s = max(st["step_s"] for rs in per_rank.values()
                 for st in rs[1:] or rs)
    ok = update_rel_err <= HARNESS_PARAM_TOL and \
        moment_err <= XPROC_MOMENT_TOL and \
        norm_errs["real"] <= HARNESS_NORM_TOL and \
        loss_err <= HARNESS_LOSS_TOL and ring_ok
    emit(phase, config="llama3_8b", n_layers=L,
         depth_cut=f"{L} of {cfg.n_layers} layers (two processes' states "
                   "and the single controller's on one card)",
         tokens=[b, s + 1], steps=XPROC_STEPS, backend="gloo",
         world_size=world, mesh=axes, local=split_axes(axes, world)[0],
         strategy=XPROC_CUT_TRAIN[phase][1],
         single_controller_losses=single["losses"],
         single_controller_grad_norms=single["grad_norms"],
         single_controller_step_s=single["step_s"], losses=losses,
         loss_max_abs_err=loss_err, loss_tol=HARNESS_LOSS_TOL,
         update_rel_err=update_rel_err, tol=HARNESS_PARAM_TOL,
         update=cmp["update"], first_moment_worst_leaf_rel_err=moment_err,
         moment_tol=XPROC_MOMENT_TOL, first_moment=cmp["first_moment"],
         single_controller_rerun=cmp["single_controller_rerun"],
         grad_norm_rel_err=norm_errs["real"], norm_tol=HARNESS_NORM_TOL,
         ring_row_rel_err=None if ring_errs is None else ring_errs["real"],
         ring_out_tol=out_tol, ring_grad_tol=grad_tol,
         ring_launches=None if ring_errs is None else {
             r: next(x["ring_launches"] for x in steps if x["rank"] == r)
             for r in range(world)},
         controls=controls, step_s=step_s, tokens_per_s=b * s / step_s,
         collective_share={r: [collective_share(st) for st in rs]
                           for r, rs in per_rank.items()},
         rank_flops_per_step=flops / world,
         mfu_of_the_card=flops / step_s / peaks[0], ranks=per_rank,
         want_launches=wants, single_controller_s=single["seconds"],
         ranks_s=spawn[phase], compare_s=compare_s,
         seconds=setup["seconds"] + spawn[phase] + compare_s)
    if not ok or not all(c["broke"] for c in controls.values()):
        raise AssertionError(
            f"{phase}: update error {update_rel_err} (tol "
            f"{HARNESS_PARAM_TOL}), worst leaf's first moment {moment_err} "
            f"(tol {XPROC_MOMENT_TOL}), loss error {loss_err} (tol "
            f"{HARNESS_LOSS_TOL}), norm errors {norm_errs} (tol "
            f"{HARNESS_NORM_TOL}), ring {ring_errs}; each control must "
            f"break its bound: {controls}")
    if any(c != wants[r] for r, cs in launches.items() for c in cs):
        raise AssertionError(f"{phase} launches {launches}, want {wants} "
                             "a rank's step")
    return {"update_rel_err": update_rel_err,
            "first_moment_worst_leaf_rel_err": moment_err,
            "loss_max_abs_err": loss_err, "grad_norm_rel_err":
                norm_errs["real"], "ring_ok": ring_ok,
            "controls_broke": {c: v["broke"] for c, v in controls.items()},
            "step_s": step_s,
            "peak_memory_bytes": max(st["peak_memory_bytes"]
                                     for rs in per_rank.values()
                                     for st in rs),
            "launches": launches[world - 1][-1]}


def xproc_cut_loop(config):
    """A rank of slice 16's shared spawn: ``xproc_rank_loop`` on each
    trainer phase of XPROC_CUT, then ``xproc_ep_loop`` on xproc_ep4_w2,
    each on its config and in a directory of its own, the card freed
    after each; then its seconds to ``<out>/done_<phase>_rank<r>``."""
    import torch

    from ray_tpu_torch.train import session

    rank = session.get_context().rank
    for phase in XPROC_CUT:
        t0 = time.perf_counter()
        loop = xproc_ep_loop if phase == "xproc_ep4_w2" else xproc_rank_loop
        loop({**config["phases"][phase], "phase": phase,
              "out": os.path.join(config["out"], phase)})
        gc.collect()
        torch.cuda.empty_cache()
        # the parent checks this phase (and deletes its files) while the
        # next one runs
        mark = os.path.join(config["out"], f"done_{phase}_rank{rank}")
        with open(mark + ".tmp", "w") as f:
            json.dump({"seconds": time.perf_counter() - t0}, f)
        os.replace(mark + ".tmp", mark)


def check_xproc_cut(torch, cfg, peaks, pp_setup=None) -> dict:
    """Every layout that JAX runs across processes (slice 16): the axis
    cut at the process boundary ({fsdp 4}, {tp 4}, {sp 4}, {pp 4} and
    Mixtral's {ep 4, tp 2} at world 2) and the ring between processes
    beside other places in a process ({sp 2, tp 2}). One spawn of two
    gloo ranks (NCCL refuses two ranks on one GPU), which start up
    (``xproc_after_go``) while each phase's single controller runs on
    this card (``xproc_cut_setup``, ``xproc_ep_setup``, the card freed
    after each); then the ranks run the phases in turn, and each phase is
    held (``check_xproc_cut_train``, ``check_xproc_ep`` with the logits
    bit for bit) as soon as the ranks are done with it, while they run
    the next. ``pp_setup``: xproc_pp's (``xproc_pp_setup``), whose single
    controller on {pp 4} xproc_pp4_w2 shares. Returns each phase's
    launches."""
    import tempfile

    t_start = time.perf_counter()
    setups, times = {}, {}
    summary, counts, spawn = {}, {}, {}

    def check(phase, d):
        """Phase ``phase`` held from its ranks' files, which then go."""
        out = os.path.join(d, phase)
        if phase == "xproc_ep4_w2":
            counts[phase] = check_xproc_ep(
                torch, setups[phase], out, spawn, phase=phase,
                world=XPROC_CUT_WORLD, bit_equal=True)
            summary[phase] = {"bit_equal": True, "controls_broke": {
                "experts_from_wrong_ep": True}}
        else:
            summary[phase] = check_xproc_cut_train(
                torch, cfg, peaks, phase, setups[phase], out, spawn)
            counts[phase] = summary[phase].pop("launches")
        shutil.rmtree(out)
        del setups[phase]
        free_card(torch)

    def setup_then_check(fit, deadline):
        """While the ranks start: the single controllers, then the ranks'
        go; then each phase checked as soon as both ranks are done with
        it, while they run the next (the files of at most two phases
        exist at once)."""
        t0 = time.perf_counter()
        for phase in XPROC_CUT_TRAIN:
            if phase == "xproc_pp4_w2" and pp_setup is not None:
                setups[phase] = {**pp_setup, "shape": pp_setup["shape"][:3],
                                 "seconds": 0.0, "rank": {
                                     **pp_setup["rank"], "rank_flops":
                                     pp_setup["flops"] / XPROC_CUT_WORLD}}
                continue
            setups[phase] = xproc_cut_setup(torch, cfg, phase)
            free_card(torch)
        setups["xproc_ep4_w2"] = xproc_ep_setup(
            torch, axes=XPROC_EP_CUT_AXES, depth=XPROC_EP_CUT_DEPTH)
        free_card(torch)
        times["setup_s"] = time.perf_counter() - t0
        reference = os.path.join(d, "ep_reference.pt")
        torch.save(setups["xproc_ep4_w2"]["reference"], reference)
        phases = {p: dict(setups[p]["rank"]) for p in XPROC_CUT}
        phases["xproc_ep4_w2"]["reference"] = reference
        xproc_go(torch, d, {"phases": phases})
        times["go_s"] = time.perf_counter() - t0
        for phase in XPROC_CUT:
            marks = [os.path.join(d, f"done_{phase}_rank{r}")
                     for r in range(XPROC_CUT_WORLD)]
            while not all(os.path.exists(m) for m in marks):
                if not fit.is_alive():
                    return   # the join reports the ranks' error
                if time.perf_counter() > deadline:
                    raise AssertionError(f"xproc_cut: {phase} not done "
                                         f"within {XPROC_CUT_LIMIT_S} s")
                time.sleep(0.5)
            for m in marks:
                with open(m) as f:
                    spawn[phase] = max(spawn.get(phase, 0.0),
                                       json.load(f)["seconds"])
            check(phase, d)

    # in memory, not on disk: the card's machine takes at most 45 GiB of
    # disk writes a run, and the ranks write about 9 GB a phase
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as d:
        for phase in XPROC_CUT:
            os.makedirs(os.path.join(d, phase))
        result, fit_s = xproc_spawn(torch, "xproc_cut", None, None, None,
                                    None, d, loop=xproc_after_go,
                                    world=XPROC_CUT_WORLD,
                                    limit_s=XPROC_CUT_LIMIT_S,
                                    while_running=setup_then_check,
                                    then=xproc_cut_loop,
                                    go_within_s=XPROC_CUT_LIMIT_S)
        waited = xproc_waited(d, XPROC_CUT_WORLD)
        if set(summary) != set(XPROC_CUT):
            raise AssertionError(f"xproc_cut: checked {sorted(summary)} of "
                                 f"{XPROC_CUT}")
    emit("xproc_cut", phases=summary, world_size=XPROC_CUT_WORLD,
         checked_while_the_ranks_ran=True,
         setup_while_the_ranks_started=True, setup_s=times["setup_s"],
         go_after_s=times["go_s"], ranks_waited_for_go_s=waited,
         fit_s=fit_s, spawn_to_first_report_s=result.first_report_s,
         go_to_first_report_s=None if result.first_report_s is None
         else result.first_report_s - times["go_s"],
         ranks_s_by_phase=spawn, seconds=time.perf_counter() - t_start)
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
    return {"forward": fwd_counts, "train_step_full": step_counts,
            "median_step_s": step_s}


def gpt_tp_rules():
    """``fsdp_tp`` with the vocabulary whole, the rules of GPT-2 XL's tp
    phase: JAX itself cannot cut GPT-2's 50257 entries over tp 2 (its
    ``device_put`` refuses a dimension that does not divide, jax 0.9.0),
    so the tied embedding is cut over fsdp only and the tp blocks cut
    the heads and the MLP."""
    from ray_tpu_torch.parallel.sharding import FSDP_TP_RULES

    return FSDP_TP_RULES.with_overrides(vocab=None)


def head_aligned_qkv(d, head_dim, heads):
    """The fault of reading GPT's fused qkv as Megatron's head-aligned
    layout, ``[q_h | k_h | v_h]`` head by head (``spmd.qkv_columns``'s
    signature): JAX's is ``[q | k | v]``, cut into contiguous chunks."""
    return [[[(3 * h * head_dim + t * head_dim,
               3 * h * head_dim + (t + 1) * head_dim) for h in range(a, z)]
             for a, z in heads] for t in range(3)]


def check_tp_gpt(torch, peaks, one_card_step_s) -> dict:
    """gpt2_xl() at full width under fsdp_tp on {fsdp 2, tp 2}, every
    place on this card (``gpt_tp_rules``: each data rank four rows, its tp
    ranks 13 and 12 of the 25 heads): the gradient at depth 2 on [8, 1025]
    against the one-card trainer's (controls: the fused qkv read as
    head-aligned, no psum after wo), then 3 trainer steps at full depth
    and remat "full" beside ``check_gpt``'s one-card step. Returns the
    launch counts of the gradient and of a step."""
    import dataclasses

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg, rules = gpt.gpt2_xl(), gpt_tp_rules()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    b, s, depth, ranks = 8, 1024, 2, 4
    batch = train_batch(cfg, b, s, SEED + 5)
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    params2 = first_layers(params, depth)
    one = Trainer(cfg2, TrainConfig())
    placed = Trainer(cfg2, TrainConfig(mesh_axes=PLACED_AXES,
                                       strategy=rules))
    ref_loss, want, ref_counts = counted_grads(
        torch, one, params2, batch, {"flash_fwd": 2 * depth,
                                     "flash_bwd": depth})
    loss, got, grad_counts = counted_grads(
        torch, placed, params2, batch,
        {"flash_fwd": 2 * depth * ranks, "flash_bwd": depth * ranks})
    controls = {}
    for name, attr, fault in (
            ("qkv_chunk_read_as_head_aligned", "qkv_columns",
             head_aligned_qkv),
            ("no_psum_after_wo", "reduce_attention", lambda parts: parts)):
        orig = getattr(spmd, attr)
        setattr(spmd, attr, fault)
        try:
            controls[name] = dict(named_leaves(
                placed.loss_and_grads(params2, batch)[1]))
        finally:
            setattr(spmd, attr, orig)
    grads_against(torch, "gpt2_xl_fsdp_tp", got, want, controls,
                  config="gpt2_xl", n_layers=depth, tokens=[b, s + 1],
                  mesh=PLACED_AXES, rules="fsdp_tp, vocab=None",
                  heads_per_tp_rank=[13, 12], against="one_card",
                  loss=loss, reference_loss=ref_loss, launches=grad_counts,
                  reference_launches=ref_counts)
    for _, t in named_leaves(params2):
        t.requires_grad_(False)
    del params2, got, want, controls
    free_card(torch)

    steps, L = 3, cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainConfig(mesh_axes=PLACED_AXES, strategy=rules,
                                       warmup_steps=1))
    # the plain state, placed as views by train_step
    state = TrainState.create(params, trainer.optimizer)
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
    step_s = float(np.median(times[1:]))
    n_matmul = sum(params["blocks"][k].numel() for k in
                   ("wqkv", "wo", "w_up", "w_down")) + \
        params["embedding"].numel()
    flops = step_flops(n_matmul, b, s, L, cfg.n_heads, cfg.head_dim)
    want_counts = {"flash_fwd": 2 * L * ranks, "flash_bwd": L * ranks}
    emit("placed_train", name="gpt2_xl_fsdp_tp", config="gpt2_xl",
         n_layers=L, tokens=[b, s + 1], mesh=PLACED_AXES,
         strategy="fsdp_tp, vocab=None", remat=cfg.remat, steps=steps,
         losses=losses, grad_norms=norms, step_s=times,
         median_step_s=step_s, one_card_median_step_s=one_card_step_s,
         tokens_per_s=b * s / step_s, flops_per_step=flops,
         mfu=flops / step_s / peaks[0],
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=counts, want_launches=want_counts)
    check_losses("gpt2_xl fsdp_tp", losses, cfg.vocab_size)
    if any(c != want_counts for c in counts):
        raise AssertionError(f"gpt2_xl fsdp_tp launches per step {counts}, "
                             f"want {want_counts}")
    del state, trainer, params
    free_card(torch)
    return {"grad": grad_counts, "train_step": counts[-1]}


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
    from ray_tpu_torch.train.trainer import TrainConfig

    cfg = bert.bert_large()
    losses, counts = bert_steps(torch, cfg, TrainConfig(warmup_steps=1),
                                name="bert_large")

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    small = mlm_batch(cfg2, 2, 512, SEED + 7)
    card_against_cpu(
        torch, "bert_large_depth2_f32",
        lambda p, t, mask, types: bert.encode(
            cfg2, p, t, attention_mask=mask, token_type_ids=types),
        bert.init_params(cfg2, seed=SEED + 1, device="cuda"),
        (small["tokens"], small["attention_mask"], small["token_type_ids"]))
    return {"train_step": counts, "losses": losses}


def mlm_hook(model_cfg, params, batch):
    """The trainer's ``loss_fn`` for BERT: ``bert.mlm_loss`` on an
    ``mlm_batch``."""
    from ray_tpu_torch.models import bert

    return bert.mlm_loss(model_cfg, params, batch["tokens"],
                         batch["targets"],
                         attention_mask=batch["attention_mask"],
                         loss_mask=batch["loss_mask"])


def bert_steps(torch, cfg, train_cfg, *, name, steps=4):
    """4 trainer steps of ``cfg`` through ``mlm_hook`` from
    ``init_state(seed=SEED)`` on the [8, 512] ``mlm_batch`` of seed
    SEED + 6: attention is non-causal with segment ids, so no kernel may
    launch; the losses finite and falling. Returns the losses and the
    launch counts of the steps."""
    from ray_tpu_torch.train.trainer import Trainer

    b, s = 8, 512
    trainer = Trainer(cfg, train_cfg, loss_fn=mlm_hook)
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
    emit("train", config="bert_large", name=name, n_layers=cfg.n_layers,
         tokens=[b, s], mesh=train_cfg.mesh_axes,
         strategy=str(train_cfg.strategy), remat=cfg.remat,
         loss="mlm_loss through loss_fn", steps=steps, losses=losses,
         step_s=times, median_step_s=step_s, tokens_per_s=b * s / step_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=counts)
    if counts != {"flash_fwd": 0, "flash_bwd": 0}:
        raise AssertionError(f"{name} launched kernels {counts}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[1]):
        raise AssertionError(f"{name} losses {losses}")
    del state, trainer
    free_card(torch)
    return losses, counts


def check_tp_bert(torch, one_place_losses) -> dict:
    """bert_large() at full width and depth under fsdp_tp on {fsdp 2,
    tp 2} through the mlm_loss hook (which sees the gathered parameters),
    from the same init and batch as ``check_bert``'s one-place trainer:
    its 4 losses within 1e-2 relative of those, and falling."""
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train.trainer import TrainConfig

    tol = 1e-2
    losses, counts = bert_steps(
        torch, bert.bert_large(), TrainConfig(
            mesh_axes=PLACED_AXES, strategy="fsdp_tp", warmup_steps=1),
        name="bert_large_fsdp_tp")
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, one_place_losses)]
    emit("tp_bert", config="bert_large", mesh=PLACED_AXES,
         strategy="fsdp_tp", losses=losses,
         one_place_losses=one_place_losses, loss_rel_errs=errs, tol=tol)
    if max(errs) > tol:
        raise AssertionError(f"bert_large fsdp_tp losses {losses} against "
                             f"the one-place trainer's {one_place_losses}")
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


class CallRouting(Routing):
    """``Routing`` keyed by the order of the router's calls (it wraps
    ``ops.moe._top_k`` alone): the forward over a placed tree gathers
    each layer's router (no ``moe_ffn``, no router tensor to key by) and
    routes it once over the global tokens, as the one-place forward does,
    so without autograd the n-th call of both is layer n."""

    def __enter__(self):
        from ray_tpu_torch.ops import moe

        orig_top_k = moe._top_k

        def top_k(probs, k):
            n = len(self.choice)
            if self.replay is not None:
                idx = self.replay.choice[n]
                self.choice[n] = idx
                return probs.gather(-1, idx), idx
            vals, idx = orig_top_k(probs, k)
            self.choice[n] = idx
            return vals, idx

        moe._top_k = top_k
        self._restore = lambda: setattr(moe, "_top_k", orig_top_k)
        return self


EP_AXES = {"fsdp": 2, "ep": 2, "tp": 2}


def mixtral_placed(torch, cfg, params) -> dict:
    """The forward over a tree placed by ``moe`` (experts over ep) on
    {fsdp 2, ep 2, tp 2}, every place on this card
    (``spmd.placed_forward``), on [2, 2048], against the one-place
    forward with the routing fixed to the one-place run's: logits and aux
    loss within the family bound. Each data rank one row, its tp ranks 16
    q and 4 kv heads (K1 at [1, 16, 4, 2048, 128]), each ep place 4
    experts with half their mlp. Control: the experts' outputs returned
    from the wrong ep place. The natural routing's error and flips are
    reported. Returns the placed forward's launch counts."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.parallel.sharding import MOE_RULES, shard_tree
    from ray_tpu_torch.train import spmd

    mesh = create_mesh(EP_AXES, devices=[torch.device("cuda")] * 8)
    placed = shard_tree(params, mixtral.param_logical_axes(cfg), mesh,
                        MOE_RULES)
    tokens = train_batch(cfg, 2, 2047, SEED + 14)    # [2, 2048]
    tol = FAMILY_FORWARD_TOL

    def run():
        return spmd.placed_forward(mixtral, cfg, placed, tokens, mesh=mesh,
                                   rules=MOE_RULES, return_aux_loss=True)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CallRouting() as one:
            want, want_aux = mixtral.forward(cfg, params, tokens,
                                             return_aux_loss=True)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        with CallRouting(one):
            got, aux = run()
        torch.cuda.synchronize()
        placed_s = time.perf_counter() - t0
        counts = launch_counts()
        err = rel_rms(got, want)
        aux_err = abs(float(aux) - float(want_aux)) / abs(float(want_aux))
        shape_ok = got.shape == want.shape and bool(torch.isfinite(got).all())
        del got
        orig = spmd.gather_experts
        spmd.gather_experts = lambda xs, **kw: orig(xs[::-1], **kw)
        try:
            with CallRouting(one):
                bad = rel_rms(run()[0], want)
        finally:
            spmd.gather_experts = orig
        with CallRouting() as natural:
            natural_err = rel_rms(run()[0], want)
    want_counts = {"flash_fwd": 4 * cfg.n_layers, "flash_bwd": 0}
    emit("ep_placed_forward", config="mixtral_8x7b", n_layers=cfg.n_layers,
         tokens=[2, 2048], mesh=EP_AXES, strategy="moe", routing="fixed",
         logits_rel_rms_err=err, aux_loss=float(aux),
         one_place_aux_loss=float(want_aux), aux_rel_err=aux_err, tol=tol,
         experts_from_wrong_ep_place_rel_rms_err=bad,
         natural_routing_logits_rel_rms_err=natural_err,
         routing_flip_share=one.flips(natural), placed_forward_s=placed_s,
         one_place_forward_s=one_s, launches=counts,
         want_launches=want_counts)
    if not (shape_ok and err <= tol < bad and aux_err <= tol) or \
            counts != want_counts:
        raise AssertionError(
            f"mixtral placed forward under moe: rel err {err}, aux rel err "
            f"{aux_err} (tol {tol}; the wrong-ep-place control must exceed "
            f"it: {bad}); launches {counts}, want {want_counts}")
    del want, placed
    return counts


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
    depth-16 forward over the tree placed by ``moe``, the gradient at
    depth 2 on [2, 2049] (``mixtral_forwards``, ``mixtral_placed``,
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
    free_card(torch)
    placed_counts = mixtral_placed(torch, cfg, params)
    free_card(torch)
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
    return {"forward": forward_counts, "grad": grad_counts,
            "placed_forward": placed_counts}


# ---------------------------------------------------------------------------
# RLlib's on-policy algorithms (slice 12). No kernel of the table runs on
# these paths (a 64-wide MLP's products are plain torch ops, as in JAX);
# each is driven with the kernel counts zeroed right before it and read
# right after
# ---------------------------------------------------------------------------

RL_ITERS = 3
RL_TOL = 1e-5
# The card's update against the CPU's from the same parameters and batch:
# the parameters after RL_ITERS iterations on a batch sampled with the
# initial ones, so the ratios have left 1 (at the very first update they
# are 1 and no clip can bite). Each control changes the setting named, on
# the CPU, and must miss RL_TOL.
RL_CONTROLS = {"ppo": {"clip_eps": 0.02}, "impala": {"rho_clip": 0.5},
               "appo": {"clip_param": 0.01}}
RL_TIMED_UPDATES = 20


def rl_rel(got: list, want: list) -> float:
    """The worst over leaves of max |got - want| / max |want|."""
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - w))
                     / max(float(np.max(np.abs(w))), 1e-30))
               for g, w in zip(got, want))


def rl_leaves(tree: dict) -> list:
    return [tree[k][leaf] for k in tree for leaf in ("w", "b")]


def rl_learner(loss_fn, params: dict, device, lr: float):
    """A learner of CartPole's module at ``params`` on ``device``."""
    from functools import partial

    from ray_tpu_torch.rllib.learner_group import Learner
    from ray_tpu_torch.rllib.ppo import adam, init_module

    learner = Learner(init_fn=partial(init_module, obs_dim=4, n_actions=2),
                      loss_fn=loss_fn, tx=adam(lr), seed=SEED, device=device)
    learner.set_params(params)
    return learner


def rl_grads(learner, batch: dict) -> tuple:
    """The learner's loss's gradients (numpy, in the module's parameter
    order) and stats on ``batch``."""
    from ray_tpu_torch.rllib.learner_group import _tensors, loss_grads

    grads, stats = loss_grads(learner.loss_fn, learner.module,
                              _tensors(batch, learner.device))
    return ([g.cpu().numpy() for g in grads],
            {k: float(v) for k, v in stats.items()})


def rl_card_against_cpu(loss, kw: dict, control: dict, params: dict,
                        batch: dict, lr: float) -> dict:
    """One update from ``params`` on ``batch``, the card's against the
    CPU's: the gradients, the stats and the parameters after one Adam
    step, each within RL_TOL relative; the control's gradients (on the
    CPU) must miss it. Also each update's milliseconds: the card's by CUDA
    events over RL_TIMED_UPDATES after a warm-up (an update reads its
    stats back, so the host is in the loop), the CPU's by the host
    clock."""
    from functools import partial

    fn = partial(loss, **kw)
    card, cpu = (rl_learner(fn, params, dev, lr) for dev in ("cuda", "cpu"))
    card_g, card_s = rl_grads(card, batch)
    cpu_g, cpu_s = rl_grads(cpu, batch)
    ctl_g, _ = rl_grads(rl_learner(partial(loss, **{**kw, **control}),
                                   params, "cpu", lr), batch)
    card.update(batch)
    cpu.update(batch)
    errs = {"grads": rl_rel(card_g, cpu_g),
            "stats": rl_rel([card_s[k] for k in cpu_s],
                            list(cpu_s.values())),
            "params": rl_rel(rl_leaves(card.get_params()),
                             rl_leaves(cpu.get_params()))}
    out = {"rel_err": errs, "tol": RL_TOL, "control": control,
           "control_rel_err": rl_rel(ctl_g, cpu_g), "stats": card_s}
    if max(errs.values()) > RL_TOL or out["control_rel_err"] <= RL_TOL:
        raise AssertionError(f"card against CPU: {out}")
    out["update_ms_card_cuda_events"] = cuda_ms(lambda: card.update(batch),
                                                RL_TIMED_UPDATES)
    t0 = time.perf_counter()
    for _ in range(RL_TIMED_UPDATES):
        cpu.update(batch)
    out["update_ms_cpu_host_clock"] = (time.perf_counter() - t0) * 1e3 \
        / RL_TIMED_UPDATES
    return out


def rl_iterations(torch, algo, keys: tuple, steps: int,
                  params=None) -> dict:
    """RL_ITERS ``train()`` calls with the kernel counts zeroed right before
    and read right after: each iteration's seconds (host clock; the
    learner's last stats are read back), split into sampling and learning,
    and the environment steps a second (``steps`` consumed an
    iteration). ``params``: the learner's tensors (default: those of
    ``algo.learner.module``), which must be on the card."""
    if params is None:
        params = list(algo.learner.module.parameters())
    if not all(p.is_cuda for p in params):
        raise AssertionError("the learner's parameters are not on the card")
    zero_counts()
    rows = []
    for _ in range(RL_ITERS):
        t0 = time.perf_counter()
        r = algo.train()
        seconds = time.perf_counter() - t0
        if not all(np.isfinite(r[k]) for k in keys):
            raise AssertionError(f"non-finite stats: {r}")
        rows.append({**{k: r[k] for k in ("training_iteration",
                                          "episode_return_mean",
                                          "num_episodes", *keys)},
                     "seconds": seconds, "sample_s": r["sample_time_s"],
                     "learn_s": r["learn_time_s"],
                     "env_steps_per_s": steps / seconds,
                     "sampled_steps_per_s": steps / r["sample_time_s"]})
    torch.cuda.synchronize()
    return {"iterations": rows, "launches": launch_counts()}


def rl_normalized(batch: dict, keys: tuple) -> dict:
    """A rollout's columns ``keys``, advantages normalised as
    ``PPO.train`` does."""
    out = {k: batch[k] for k in keys}
    adv = out["advantages"]
    out["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
    return out


PPO_KEYS = ("obs", "actions", "logp", "advantages", "returns")


def check_rllib_ppo(torch, smi: str) -> dict:
    """PPO at its defaults on CartPole-v1 (2 workers, fragment 256, 4 SGD
    passes of minibatch 128, hidden 64) on the card, RL_ITERS iterations;
    then the card's update against the CPU's."""
    from ray_tpu_torch.rllib.ppo import PPOConfig, _RolloutWorker, ppo_loss

    algo = PPOConfig().build()
    cfg = algo.config
    theta0 = algo.learner.get_params()
    run = rl_iterations(torch, algo, ("policy_loss", "vf_loss", "entropy"),
                        cfg.num_rollout_workers * cfg.rollout_fragment_length)
    batch = rl_normalized(_RolloutWorker(cfg.env, SEED + 1000).sample(
        theta0, cfg.rollout_fragment_length, cfg.gamma, cfg.lam), PPO_KEYS)
    check = rl_card_against_cpu(
        ppo_loss, {"clip_eps": cfg.clip_eps,
                   "entropy_coeff": cfg.entropy_coeff,
                   "vf_coeff": cfg.vf_coeff},
        RL_CONTROLS["ppo"], algo.learner.get_params(),
        {k: v[:cfg.minibatch_size] for k, v in batch.items()}, cfg.lr)
    emit("rllib_ppo", card=smi, env=cfg.env,
         minibatches_per_iteration=cfg.num_sgd_iter * -(
             -cfg.num_rollout_workers * cfg.rollout_fragment_length
             // cfg.minibatch_size), **run, card_against_cpu=check)
    return run["launches"]


def check_rllib_bandit(torch, smi: str) -> dict:
    """PPO learns Bandit-v0 on the card (tests/test_rllib.py's check: the
    mean return above 0.85 after 7 iterations)."""
    from ray_tpu_torch.rllib.ppo import PPOConfig

    algo = (PPOConfig().environment("Bandit-v0")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(lr=0.01, num_sgd_iter=4, minibatch_size=128,
                      entropy_coeff=0.0, gamma=0.0).build())
    zero_counts()
    t0 = time.perf_counter()
    returns = [algo.train()["episode_return_mean"] for _ in range(7)]
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    emit("rllib_bandit", card=smi, returns=returns, seconds=seconds,
         launches=counts)
    if returns[-1] <= 0.85:
        raise AssertionError(f"PPO did not learn the bandit: {returns}")
    return counts


def check_rllib_impala(torch, smi: str, name: str) -> dict:
    """IMPALA, or APPO, at its defaults on CartPole-v1 (2 workers, unroll
    64) on the card, RL_ITERS iterations; then the card's update against
    the CPU's on trajectories sampled with the initial parameters."""
    from ray_tpu_torch.rllib.appo import APPOConfig
    from ray_tpu_torch.rllib.impala import (IMPALAConfig, _TrajectoryWorker,
                                            impala_loss)

    algo = (IMPALAConfig if name == "impala" else APPOConfig)().build()
    cfg = algo.config
    theta0 = algo.learner.get_params()
    run = rl_iterations(
        torch, algo, ("policy_loss", "vf_loss", "entropy", "mean_rho"),
        cfg.num_rollout_workers * cfg.num_envs_per_worker
        * cfg.unroll_length)
    parts = [_TrajectoryWorker(cfg.env, SEED + 1000 * (i + 1)).sample(
        theta0, cfg.unroll_length) for i in range(cfg.num_rollout_workers)]
    batch = {k: np.concatenate([p[k] for p in parts])
             for k in ("obs", "actions", "behavior_logits", "rewards",
                       "dones", "bootstrap_obs")}
    check = rl_card_against_cpu(
        impala_loss, {
            "gamma": cfg.gamma, "rho_clip": cfg.rho_clip,
            "c_clip": cfg.c_clip, "entropy_coeff": cfg.entropy_coeff,
            "vf_coeff": cfg.vf_coeff, "clip_param": cfg.clip_param},
        RL_CONTROLS[name], algo.learner.get_params(), batch, cfg.lr)
    emit(f"rllib_{name}", card=smi, env=cfg.env, clip_param=cfg.clip_param,
         **run, card_against_cpu=check)
    return run["launches"]


def check_rllib_learners(torch, smi: str) -> dict:
    """The learner plane on the card, PPO's loss on three CartPole
    minibatches of 128 rows from the same parameters: mode "mesh" on 2
    places of this card against one learner, then mode "actors" on 2 gloo
    rank processes of this card against mode "mesh" (stats and final
    parameters within RL_TOL; control: one learner on the first half of
    each minibatch, a rank that skipped the all-reduce)."""
    from functools import partial

    from ray_tpu_torch.rllib.learner_group import Learner, LearnerGroup
    from ray_tpu_torch.rllib.ppo import (PPOConfig, _RolloutWorker, adam,
                                         init_module, ppo_loss)

    cfg = PPOConfig()
    theta0 = init_module(SEED, 4, 2, device="cpu").numpy_tree()
    sample = rl_normalized(_RolloutWorker(cfg.env, SEED + 1000).sample(
        theta0, 3 * cfg.minibatch_size, cfg.gamma, cfg.lam), PPO_KEYS)
    mb = cfg.minibatch_size
    batches = [{k: v[i * mb:(i + 1) * mb] for k, v in sample.items()}
               for i in range(3)]
    kw = dict(init_fn=partial(init_module, obs_dim=4, n_actions=2),
              loss_fn=partial(ppo_loss, clip_eps=cfg.clip_eps,
                              entropy_coeff=cfg.entropy_coeff,
                              vf_coeff=cfg.vf_coeff),
              tx=adam(cfg.lr), seed=SEED, device="cuda")

    def run(learner, batches):
        learner.set_params(theta0)
        stats, seconds = [], []
        for b in batches:
            t0 = time.perf_counter()
            stats.append(learner.update(b))
            seconds.append(time.perf_counter() - t0)
        return stats, learner.get_params(), seconds

    def err(a, b):
        return max(rl_rel(rl_leaves(a[1]), rl_leaves(b[1])),
                   rl_rel([s[k] for s in a[0] for k in s],
                          [s[k] for s in b[0] for k in s]))

    zero_counts()
    single = run(Learner(**kw), batches)
    mesh_group = LearnerGroup(num_learners=2, mode="mesh", **kw)
    mesh = run(mesh_group, batches)
    control = run(Learner(**kw), [{k: v[:mb // 2] for k, v in b.items()}
                                  for b in batches])
    t0 = time.perf_counter()
    actors_group = LearnerGroup(num_learners=2, mode="actors", **kw)
    spawn_s = time.perf_counter() - t0
    try:
        actors = run(actors_group, batches)
    finally:
        actors_group.stop()
    counts = launch_counts()
    errs = {"mesh_vs_single": err(mesh, single),
            "actors_vs_mesh": err(actors, mesh)}
    control_err = err(control, mesh)
    emit("rllib_learners", card=smi,
         mesh_places=[str(d) for d in mesh_group._impl.places],
         actors_backend=actors_group._impl.group.backend, rel_err=errs,
         tol=RL_TOL, control_half_batch_rel_err=control_err,
         update_s={"single": single[2], "mesh": mesh[2],
                   "actors": actors[2]},
         actors_spawn_s=spawn_s, launches=counts)
    if max(errs.values()) > RL_TOL or control_err <= RL_TOL:
        raise AssertionError(f"learner plane: {errs}, control {control_err}")
    return counts


# ---------------------------------------------------------------------------
# RLlib's replay and offline algorithms (slice 14): DQN with its variants,
# SAC, TD3 and DDPG, BC, CQL and MARWIL. Their updates are functions that
# step a tree or module in place; no kernel of the table runs there
# ---------------------------------------------------------------------------

# Iterations of each replay algorithm at its defaults: 2 workers x 128
# steps an iteration and learning_starts 500, so the second and third
# iterations update
RL_REPLAY_ITERS = 3
# the device of the card side of ``rl_fn_card_against_cpu``
RL_CARD = "cuda"


def replayed_tanh():
    """tanh whose values are given, with tanh's gradient at them: SAC's
    card-against-CPU check runs the CPU's update on the card's squashed
    actions (``rllib.sac._sample_action``: one ulp of tanh near
    saturation moves a row's log-prob by up to 0.4 nats, and float32 tanh
    differs in the last ulp between the card and the CPU). Returns
    ``apply(x, a)``."""
    import torch

    class ReplayTanh(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, a):
            ctx.save_for_backward(a)
            return a.clone()

        @staticmethod
        def backward(ctx, g):
            (a,) = ctx.saved_tensors
            return g * (1 + a) * (1 - a), None

    return ReplayTanh.apply


def rl_fn_card_against_cpu(make, control: dict, replay_tanh=False) -> dict:
    """One functional update, the card's against the CPU's from the same
    state and batch: ``make(device, **over)`` builds the update's state
    on ``device`` and returns ``step()`` (one update in place, returning
    its stats) and ``read(stats)`` (the stats and every stepped leaf as
    numpy). Each leaf within RL_TOL relative; the control's (the CPU's
    with ``control``) must miss it. With ``replay_tanh`` (SAC), the CPU's
    updates take the card's squashing tanh values; the difference with
    each device's own tanh is reported beside. Also an update's
    milliseconds: the card's by CUDA events over RL_TIMED_UPDATES after a
    warm-up, the CPU's by the host clock."""
    from ray_tpu_torch.rllib import sac

    own = sac._tanh
    runs = {}
    try:
        recorded = []
        if replay_tanh:
            def record(x):
                a = own(x)
                recorded.append(a.detach().cpu())
                return a
            sac._tanh = record
        card_step, card_read = make(RL_CARD)
        runs["card"] = card_read(card_step())
        for name, over in (("cpu", {}), ("control", control)):
            if replay_tanh:
                replay, apply = iter(recorded), replayed_tanh()
                sac._tanh = lambda x: apply(x, next(replay).to(x.device))
            step, read = make("cpu", **over)
            runs[name] = read(step())
        if replay_tanh:
            sac._tanh = own
            step, read = make("cpu")
            runs["cpu_own_tanh"] = read(step())
    finally:
        sac._tanh = own
    out = {"rel_err": rl_rel(runs["card"], runs["cpu"]), "tol": RL_TOL,
           "control": {k: sorted(v) if k == "batch" else v
                       for k, v in control.items()},
           "control_rel_err": rl_rel(runs["control"], runs["cpu"])}
    if replay_tanh:
        out["rel_err_own_tanh"] = rl_rel(runs["card"], runs["cpu_own_tanh"])
    if out["rel_err"] > RL_TOL or out["control_rel_err"] <= RL_TOL:
        raise AssertionError(f"card against CPU: {out}")
    out["update_ms_card_cuda_events"] = cuda_ms(card_step, RL_TIMED_UPDATES)
    step, _ = make("cpu")
    t0 = time.perf_counter()
    for _ in range(RL_TIMED_UPDATES):
        step()
    out["update_ms_cpu_host_clock"] = (time.perf_counter() - t0) * 1e3 \
        / RL_TIMED_UPDATES
    return out


def rl_numpy(values) -> list:
    return [v.detach().cpu().numpy() for v in values]


def rl_replay_iterations(torch, algo, leaves: list, keys: tuple,
                         steps: int) -> dict:
    """RL_REPLAY_ITERS ``train()`` calls of a replay algorithm with the
    kernel counts zeroed right before and read right after: each
    iteration's seconds (host clock; an update reads its loss back),
    split into sampling and learning, the environment steps a second and
    the result's ``keys``; at least two iterations must update."""
    if not all(x.is_cuda for x in leaves):
        raise AssertionError("the learner's parameters are not on the card")
    zero_counts()
    rows = []
    for _ in range(RL_REPLAY_ITERS):
        t0 = time.perf_counter()
        r = algo.train()
        seconds = time.perf_counter() - t0
        rows.append({**{k: r.get(k) for k in ("training_iteration",
                                               "buffer_size", *keys)},
                     "seconds": seconds, "sample_s": r["sample_time_s"],
                     "learn_s": r["learn_time_s"],
                     "env_steps_per_s": steps / seconds})
    torch.cuda.synchronize()
    updated = [row for row in rows if row[keys[0]] is not None]
    if len(updated) < 2 or not all(np.isfinite(row[k]) for row in updated
                                   for k in keys[:1]):
        raise AssertionError(f"fewer than two iterations updated: {rows}")
    return {"iterations": rows, "launches": launch_counts()}


def dqn_make(update, online: dict, target: dict, batch: dict, lr: float,
             kw: dict):
    """``make`` of ``rl_fn_card_against_cpu`` for a Q-net update
    (``_dqn_update``, ``_c51_update``); ``over`` may hold a ``batch`` of
    columns to replace."""
    from functools import partial

    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib.dqn import frozen_copy, to_device
    from ray_tpu_torch.rllib.ppo import adam

    def make(device, **over):
        cols = over.pop("batch", {})
        params = convert.policy_value_from_numpy(online, device=device)
        tgt = frozen_copy(convert.policy_value_from_numpy(target,
                                                          device=device))
        tx = adam(lr)
        opt = tx.init(dict(params.named_parameters()))
        b = to_device({**batch, **cols}, device)
        f = partial(update, tx=tx, **{**kw, **over})
        return (lambda: f(params, opt, tgt, b),
                lambda stats: rl_numpy([*stats, *params.parameters()]))

    return make


def check_rllib_dqn(torch, smi: str) -> dict:
    """DQN at its defaults on CartPole-v1 (2 workers x 128 steps, replay
    50,000, learning_starts 500, 32 updates of 64 an iteration, double Q,
    hidden 64) on the card, RL_REPLAY_ITERS iterations; then one update
    each of double DQN, dueling, C51 (51 atoms) and prioritized replay of
    3-step transitions, the card's against the CPU's from the same
    parameters, targets and batch; then DQN learns Bandit-v0
    (tests/test_rllib.py's check)."""
    from ray_tpu_torch.rllib.dqn import (DQNConfig, _c51_update,
                                         _dqn_update, _DQNRolloutWorker,
                                         init_qnet)
    from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, \
        nstep_batch

    algo = DQNConfig().build()
    cfg = algo.config
    theta0 = algo.params.numpy_tree()
    run = rl_replay_iterations(
        torch, algo, list(algo.params.parameters()), ("td_loss", "epsilon"),
        cfg.num_rollout_workers * cfg.rollout_fragment_length)
    online, target = algo.params.numpy_tree(), algo.target_params.numpy_tree()
    rng = np.random.default_rng(SEED)
    batch = algo.buffer.sample(cfg.train_batch_size, rng)
    batch["weights"] = np.ones(cfg.train_batch_size, np.float32)
    # prioritized replay of 3-step transitions from one worker's rollout
    per = PrioritizedReplayBuffer(4096, algo.obs_dim, alpha=cfg.pr_alpha,
                                  gamma=cfg.gamma)
    per.add_batch(nstep_batch(_DQNRolloutWorker(cfg.env, SEED + 1000).sample(
        theta0, 1024, 1.0), 3, cfg.gamma))
    per.update_priorities(np.arange(512), rng.exponential(size=512))
    per_batch = per.sample(cfg.train_batch_size, rng, beta=cfg.pr_beta0)
    per_batch.pop("idx")
    c51 = [init_qnet(SEED + i, algo.obs_dim, algo.n_actions, cfg.hidden, 51,
                     device="cpu").numpy_tree() for i in (0, 1)]
    c51_kw = dict(n_actions=algo.n_actions, num_atoms=51, v_min=cfg.v_min,
                  v_max=cfg.v_max)
    checks = {}
    for name, update, params, b, kw, control in (
            ("double", _dqn_update, (online, target), batch,
             {"double_q": True}, {"double_q": False}),
            ("dueling", _dqn_update, (online, target), batch,
             {"double_q": True, "dueling": True}, {"dueling": False}),
            ("c51", _c51_update, c51, batch, {"double_q": True, **c51_kw},
             {"double_q": False}),
            ("per_nstep3", _dqn_update, (online, target), per_batch,
             {"double_q": True},
             {"batch": {"weights": np.ones(cfg.train_batch_size,
                                           np.float32)}})):
        checks[name] = rl_fn_card_against_cpu(
            dqn_make(update, *params, b, cfg.lr, kw), control)
    # tests/test_rllib.py's learning check, on the card
    bandit = (DQNConfig().environment("Bandit-v0")
              .rollouts(num_rollout_workers=2, rollout_fragment_length=64)
              .training(learning_starts=64, num_updates_per_iter=16,
                        epsilon_decay_iters=5, target_update_freq=2).build())
    t0 = time.perf_counter()
    returns = [bandit.train()["episode_return_mean"] for _ in range(12)]
    learned = [bandit.compute_action([1.0, 1.0]),
               bandit.compute_action([-1.0, 1.0])]
    emit("rllib_dqn", card=smi, env=cfg.env, **run,
         per_nstep3_discounts=sorted(set(np.round(
             per_batch["discounts"], 6).tolist())),
         card_against_cpu=checks, bandit_returns=returns,
         bandit_greedy_actions=learned,
         bandit_s=time.perf_counter() - t0)
    if learned != [1, 0]:
        raise AssertionError(f"DQN did not learn the bandit: {learned}")
    return run["launches"]


def continuous_make(update, params: dict, targets: dict, batch: dict,
                    noise, lr: float, kw: dict, *args):
    """``make`` of ``rl_fn_card_against_cpu`` for SAC's and TD3's updates
    (``args``: TD3's ``do_policy``)."""
    from functools import partial

    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib.dqn import init_opt_state, to_device
    from ray_tpu_torch.rllib.ppo import adam
    from ray_tpu_torch.rllib.sac import frozen_tree, leaves

    def make(device, **over):
        import torch

        p = convert.mlp_tree_from_numpy(params, device=device)
        t = frozen_tree(convert.mlp_tree_from_numpy(targets, device=device))
        tx = adam(lr)
        opt = init_opt_state(tx, leaves(p))
        b = to_device(batch, device)
        n = torch.from_numpy(noise).to(device)
        f = partial(update, tx=tx, **{**kw, **over})
        return (lambda: f(p, t, opt, b, n, *args),
                lambda m: rl_numpy([*m.values(), *leaves(p), *leaves(t)]))

    return make


def check_rllib_continuous(torch, smi: str, name: str) -> dict:
    """SAC, TD3 or DDPG at its defaults on Pendulum-v1 (2 workers x 128
    steps, learning_starts 500, 32 updates of 128 an iteration, hidden
    64) on the card, RL_REPLAY_ITERS iterations; then one update, the
    card's against the CPU's from the trained parameters and targets on a
    replay batch with the same noise (TD3 and DDPG: a policy step;
    control: gamma 0.9); then the learning check on ContinuousBandit-v0
    (tests/test_rllib.py's: the policy's action within 0.25 of the
    optimum 0.5 after 12 iterations; DDPG's check is that it is TD3's
    degenerate config, one critic, trained one iteration)."""
    from ray_tpu_torch.rllib import sac, td3
    from ray_tpu_torch.rllib.sac import SACConfig, _sac_update, numpy_tree
    from ray_tpu_torch.rllib.td3 import DDPGConfig, TD3Config, _td3_update

    config = {"sac": SACConfig, "td3": TD3Config, "ddpg": DDPGConfig}[name]
    algo = config().build()
    cfg = algo.config
    run = rl_replay_iterations(
        torch, algo, sac.leaves(algo.params),
        ("critic_loss", "actor_loss"),
        cfg.num_rollout_workers * cfg.rollout_fragment_length)
    batch = algo.buffer.sample(cfg.train_batch_size,
                               np.random.default_rng(SEED))
    noise = algo._noise(cfg.train_batch_size)
    if name == "sac":
        make = continuous_make(
            _sac_update, numpy_tree(algo.params), numpy_tree(algo.target_q),
            batch, noise, cfg.lr, dict(gamma=cfg.gamma, tau=cfg.tau,
                                       target_entropy=-float(
                                           algo.action_dim)))
    else:
        make = continuous_make(
            _td3_update, numpy_tree(algo.params), numpy_tree(algo.targets),
            batch, noise, cfg.lr, dict(
                gamma=cfg.gamma, tau=cfg.tau, target_noise=cfg.target_noise,
                noise_clip=cfg.noise_clip, twin_q=cfg.twin_q), True)
    check = rl_fn_card_against_cpu(make, {"gamma": 0.9},
                                   replay_tanh=name == "sac")
    t0 = time.perf_counter()
    bandit_cfg = config().environment("ContinuousBandit-v0").rollouts(
        num_rollout_workers=2, rollout_fragment_length=64)
    if name == "ddpg":
        bandit = bandit_cfg.rollouts(num_rollout_workers=1,
                                     rollout_fragment_length=32).training(
            learning_starts=32, num_updates_per_iter=8).build()
        result = bandit.train()
        learned = {"degenerate": [cfg.twin_q, cfg.policy_delay,
                                  cfg.target_noise],
                   "critics": sorted(bandit.params),
                   "iteration": result["training_iteration"]}
        ok = (learned["critics"] == ["actor", "q1"]
              and learned["degenerate"] == [False, 1, 0.0]
              and isinstance(bandit, td3.DDPG))
    else:
        kw = dict(learning_starts=128, train_batch_size=64,
                  num_updates_per_iter=64, lr=3e-3, gamma=0.0)
        if name == "td3":
            kw["expl_noise"] = 0.3
        bandit = bandit_cfg.training(**kw).build()
        for _ in range(12):
            result = bandit.train()
        action = float(bandit.compute_single_action(
            np.zeros(1, np.float32))[0])
        learned = {"action": action, "optimum": 0.5,
                   "critic_loss": result["critic_loss"]}
        ok = abs(action - 0.5) < 0.25
    emit(f"rllib_{name}", card=smi, env=cfg.env, **run,
         card_against_cpu=check, bandit=learned,
         bandit_s=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{name} learning check: {learned}")
    return run["launches"]


def offline_make(update, params: dict, batch: dict, lr: float, kw: dict,
                 target=None):
    """``make`` of ``rl_fn_card_against_cpu`` for BC's, CQL's and
    MARWIL's updates (CQL's with a target network)."""
    from functools import partial

    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib.dqn import frozen_copy, to_device
    from ray_tpu_torch.rllib.ppo import adam

    def make(device, **over):
        import torch

        cols = over.pop("batch", {})
        m = convert.policy_value_from_numpy(params, device=device)
        tx = adam(lr)
        opt = tx.init(dict(m.named_parameters()))
        b = to_device({**batch, **cols}, device)
        f = partial(update, tx=tx, **{**kw, **over})
        args = () if target is None else (frozen_copy(
            convert.policy_value_from_numpy(target, device=device)),)

        def step():
            stats = f(m, opt, *args, b)
            if isinstance(stats, dict):
                return list(stats.values())
            return [stats] if isinstance(stats, torch.Tensor) else stats

        return step, lambda stats: rl_numpy([*stats, *m.parameters()])

    return make


def check_rllib_offline(torch, smi: str) -> dict:
    """Offline RL on the card from a dataset collected into a temporary
    directory (CartPole-v1, 4,000 random steps, ``collect_dataset``): BC
    and CQL 2 epochs each (train_batch_size 256), MARWIL 20 iterations
    (batch 256), at the JAX package's defaults; then one update of each,
    the card's against the CPU's (controls: the logged actions flipped,
    cql_alpha 0.5, beta 0.5)."""
    import tempfile

    from ray_tpu_torch.rllib.marwil import MARWILConfig, _marwil_update
    from ray_tpu_torch.rllib.offline import (BCConfig, CQLConfig,
                                             OfflineDataset, _bc_update,
                                             _cql_update, collect_dataset)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = collect_dataset("CartPole-v1", d, num_steps=4000, seed=SEED)
        collect_s = time.perf_counter() - t0
        algos = {"bc": BCConfig(input_path=path).build(),
                 "cql": CQLConfig(input_path=path).build(),
                 "marwil": MARWILConfig(input_path=path).build()}
        batch = next(OfflineDataset(path).minibatches(
            256, np.random.default_rng(SEED)))
    if not all(p.is_cuda for a in algos.values()
               for p in a.params.parameters()):
        raise AssertionError("the learners' parameters are not on the card")
    zero_counts()
    runs = {}
    for name, algo in algos.items():
        rows = []
        for _ in range(20 if name == "marwil" else 2):
            t0 = time.perf_counter()
            r = algo.train()
            rows.append({**{k: v for k, v in r.items()
                            if isinstance(v, float)},
                         "seconds": time.perf_counter() - t0})
        if not all(np.isfinite(v) for row in rows for v in row.values()):
            raise AssertionError(f"{name}: non-finite stats {rows}")
        runs[name] = {"iterations": len(rows), "first": rows[0],
                      "last": rows[-1],
                      "median_s": float(np.median([r["seconds"]
                                                   for r in rows]))}
    torch.cuda.synchronize()
    counts = launch_counts()
    marwil = algos["marwil"]
    mb = {k: v[:256] for k, v in marwil.data.items()}
    checks = {
        "bc": rl_fn_card_against_cpu(
            offline_make(_bc_update, algos["bc"].params.numpy_tree(), batch,
                         1e-3, {}),
            {"batch": {"actions": 1 - batch["actions"]}}),
        "cql": rl_fn_card_against_cpu(
            offline_make(_cql_update, algos["cql"].params.numpy_tree(),
                         batch, 1e-3, {"gamma": 0.99, "alpha": 1.0},
                         target=algos["cql"].target_params.numpy_tree()),
            {"alpha": 0.5}),
        "marwil": rl_fn_card_against_cpu(
            offline_make(_marwil_update, marwil.params.numpy_tree(), mb,
                         1e-3, {"beta": 1.0, "vf_coeff": 1.0,
                                "sqd_adv_norm": marwil._sqd_adv_norm}),
            {"beta": 0.5})}
    emit("rllib_offline", card=smi, env="CartPole-v1", dataset_rows=4000,
         collect_s=collect_s, runs=runs, card_against_cpu=checks,
         launches=counts)
    return counts


# ---------------------------------------------------------------------------
# The rest of RLlib (slice 15): the recurrent core (RecurrentPPO, IMPALA's
# cell), multi-agent PPO and DreamerV3. No kernel lies on these paths
# either (32- to 128-wide MLPs and GRU/LSTM cells are plain torch ops);
# each is driven with the kernel counts zeroed right before it and read
# right after
# ---------------------------------------------------------------------------

def rl_module_make(loss, params: dict, batch: dict, lr: float, kw: dict,
                   opt_state: dict):
    """``make`` of ``rl_fn_card_against_cpu`` for an update of one
    module (``sgd_step`` of ``loss`` with ``adam(lr)``): a recurrent
    module from its numpy tree (with ``cell_type``), else PPO's module,
    its Adam state a copy of ``opt_state`` (the trained algorithm's: from
    a fresh state, Adam's first step turns a gradient's float32 noise
    where it is near 0 into a step of the learning rate's size); ``over``
    changes the loss's settings."""
    from functools import partial

    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib.dqn import to_device
    from ray_tpu_torch.rllib.learner_group import sgd_step
    from ray_tpu_torch.rllib.ppo import adam

    def make(device, **over):
        module = (convert.recurrent_from_numpy if "cell" in params else
                  convert.policy_value_from_numpy)(params, device=device)
        tx = adam(lr)
        opt = {"count": opt_state["count"],
               **{k: {name: t.detach().to(device, copy=True)
                      for name, t in opt_state[k].items()}
                  for k in ("mu", "nu")}}
        b = to_device(batch, device)
        fn = partial(loss, **{**kw, **over})
        return (lambda: sgd_step(fn, module, opt, b, tx),
                lambda stats: rl_numpy([*stats.values(),
                                        *module.parameters()]))

    return make


def check_rllib_recurrent(torch, smi: str) -> dict:
    """RecurrentPPO with a gru and with an lstm core on MemoryCueEnv at its
    defaults (fragment 256 in sequences of 16, hidden 32, 4 passes over
    the whole batch), then IMPALA with ``cell="lstm"`` at its defaults on
    CartPole-v1 (2 workers, unroll 64, hidden 64), RL_ITERS iterations
    each on the card; then one update of each, the card's against the
    CPU's from the trained parameters and Adam state on a batch sampled
    with the initial ones (controls: clip_eps 0.02, rho_clip 0.5)."""
    from ray_tpu_torch.rllib.impala import (TRAJECTORY_KEYS, IMPALAConfig,
                                            _TrajectoryWorker, impala_loss)
    from ray_tpu_torch.rllib.recurrent import (BATCH_KEYS, MemoryCueEnv,
                                               RecurrentPPOConfig,
                                               _RecurrentRolloutWorker,
                                               normalize_masked, rppo_loss)

    runs, checks, counts = {}, {}, {}
    for cell in ("gru", "lstm"):
        algo = RecurrentPPOConfig(cell=cell).environment(MemoryCueEnv).build()
        cfg = algo.config
        theta0 = algo._params_np()
        runs[f"rppo_{cell}"] = rl_iterations(
            torch, algo, ("policy_loss", "entropy"),
            cfg.num_rollout_workers * cfg.rollout_fragment_length,
            params=list(algo.module.parameters()))
        counts[f"rllib_rppo_{cell}_3_iterations"] = \
            runs[f"rppo_{cell}"]["launches"]
        batch = _RecurrentRolloutWorker(cfg.env, SEED + 1000,
                                        cfg.max_seq_len).sample(
            theta0, cfg.rollout_fragment_length, cfg.gamma, cfg.lam)
        batch = normalize_masked({k: batch[k] for k in BATCH_KEYS})
        checks[f"rppo_{cell}"] = rl_fn_card_against_cpu(rl_module_make(
            rppo_loss, algo._params_np(), batch, cfg.lr,
            {"clip_eps": cfg.clip_eps, "entropy_coeff": cfg.entropy_coeff,
             "vf_coeff": cfg.vf_coeff}, algo.opt_state), {"clip_eps": 0.02})
    algo = IMPALAConfig(cell="lstm").build()
    cfg = algo.config
    theta0 = algo._params_np()
    runs["impala_lstm"] = rl_iterations(
        torch, algo, ("policy_loss", "vf_loss", "entropy", "mean_rho"),
        cfg.num_rollout_workers * cfg.num_envs_per_worker
        * cfg.unroll_length)
    counts["rllib_impala_lstm_3_iterations"] = runs["impala_lstm"]["launches"]
    parts = [_TrajectoryWorker(cfg.env, SEED + 1000 * (i + 1), 1,
                               "lstm").sample(theta0, cfg.unroll_length)
             for i in range(cfg.num_rollout_workers)]
    batch = {k: np.concatenate([p[k] for p in parts])
             for k in (*TRAJECTORY_KEYS, "h0")}
    checks["impala_lstm"] = rl_fn_card_against_cpu(rl_module_make(
        impala_loss, algo._params_np(), batch, cfg.lr,
        {"gamma": cfg.gamma, "rho_clip": cfg.rho_clip, "c_clip": cfg.c_clip,
         "entropy_coeff": cfg.entropy_coeff, "vf_coeff": cfg.vf_coeff,
         "clip_param": cfg.clip_param, "cell": "lstm"},
        algo.learner.opt_state), {"rho_clip": 0.5})
    emit("rllib_recurrent", card=smi, runs=runs, card_against_cpu=checks,
         env={"rppo": "MemoryCueEnv", "impala_lstm": cfg.env})
    return counts


def check_rllib_multi_agent(torch, smi: str) -> dict:
    """MultiAgentPPO on CoopMatch-v0 at its defaults (fragment 128,
    minibatch 128, hidden 64), one policy shared by both agents and one
    policy an agent, 2 iterations each on the card; then each policy's
    update against the CPU's from its trained parameters and Adam state
    on its first minibatch of a rollout sampled with the initial ones
    (control: clip_eps 0.02)."""
    from ray_tpu_torch.rllib.multi_agent import (MultiAgentPPOConfig,
                                                 _MultiAgentRolloutWorker)
    from ray_tpu_torch.rllib.ppo import ppo_loss

    runs, checks, counts = {}, {}, {}
    for name, policies, mapping in (
            ("shared", ("shared",), lambda aid: "shared"),
            ("independent", ("p_a0", "p_a1"), lambda aid: f"p_{aid}")):
        algo = MultiAgentPPOConfig().multi_agent(
            policies=policies, policy_mapping_fn=mapping).build()
        cfg = algo.config
        theta0 = algo._policies_np()
        params = [p for pid in policies
                  for p in algo.policies[pid].parameters()]
        if not all(p.is_cuda for p in params):
            raise AssertionError("the policies are not on the card")
        zero_counts()
        rows = []
        for _ in range(2):
            t0 = time.perf_counter()
            r = algo.train()
            rows.append({**{k: r[k] for k in (
                "training_iteration", "episode_return_mean", "num_episodes",
                "policy_loss", "entropy", "num_env_steps_sampled",
                "policy_ids")}, "seconds": time.perf_counter() - t0,
                "sample_s": r["sample_time_s"], "learn_s": r["learn_time_s"]})
        torch.cuda.synchronize()
        counts[f"rllib_multi_agent_{name}_2_iterations"] = launch_counts()
        runs[name] = {"iterations": rows,
                      "launches": counts[f"rllib_multi_agent_{name}"
                                         "_2_iterations"]}
        if not all(np.isfinite(row[k]) for row in rows
                   for k in ("policy_loss", "entropy")):
            raise AssertionError(f"non-finite stats: {rows}")
        # two fragments' worth: normalised as a whole, a policy's first
        # minibatch is not the whole batch, whose advantages have mean 0
        # (its policy loss is then a cancellation, ill-posed relatively)
        out = _MultiAgentRolloutWorker(cfg.env, mapping, SEED + 1000).sample(
            theta0, 2 * cfg.rollout_fragment_length, cfg.gamma, cfg.lam)
        trained = algo._policies_np()
        for pid, b in out["batches"].items():
            b = rl_normalized(b, tuple(b))
            checks[f"{name}/{pid}"] = rl_fn_card_against_cpu(rl_module_make(
                ppo_loss, trained[pid],
                {k: v[:cfg.minibatch_size] for k, v in b.items()}, cfg.lr,
                {"clip_eps": cfg.clip_eps,
                 "entropy_coeff": cfg.entropy_coeff,
                 "vf_coeff": cfg.vf_coeff}, algo.opt_states[pid]),
                {"clip_eps": 0.02})
    emit("rllib_multi_agent", card=smi, env="CoopMatch-v0", runs=runs,
         card_against_cpu=checks)
    return counts


def dreamer_make(algo, batch: dict, noise: dict, draws: list):
    """``make`` of ``rl_fn_card_against_cpu`` for ``_dreamer_update`` from
    ``algo``'s state (parameters, EMA target, the three Adam states, the
    return scale) on ``batch`` with the Gumbel draws ``noise``; ``over``
    may hold another ``gamma``. Each made update's first step appends its
    device, its sampled indices and its smallest sampling margin (the gap
    between a draw's two largest entries) to ``draws``."""
    from functools import partial

    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib.dqn import to_device
    from ray_tpu_torch.rllib.dreamer import _dreamer_update
    from ray_tpu_torch.rllib.sac import leaves, numpy_tree

    state = {"params": numpy_tree(algo.params),
             "target": numpy_tree(algo.target_critic),
             "opts": [(o["count"], rl_numpy(leaves(o["mu"])),
                       rl_numpy(leaves(o["nu"])))
                      for o in (algo.opt_wm, algo.opt_actor,
                                algo.opt_critic)],
             "ret_scale": float(algo.ret_scale)}
    c = algo.config
    cfg_s = (algo.n_actions, c.n_cats, c.n_classes, c.h_dim, c.horizon,
             c.gamma, c.lam, c.entropy_coef, c.free_nats, c.kl_dyn, c.kl_rep,
             c.tau)

    def make(device, gamma=None):
        import torch

        params = convert.dreamer_from_numpy(state["params"], device=device)
        target = convert.dreamer_from_numpy({"critic": state["target"]},
                                            device=device)["critic"]
        opts = [{"count": count,
                 "mu": {str(i): torch.tensor(m, device=device)
                        for i, m in enumerate(mu)},
                 "nu": {str(i): torch.tensor(v, device=device)
                        for i, v in enumerate(nu)}}
                for count, mu, nu in state["opts"]]
        scale = [torch.tensor(state["ret_scale"], device=device)]
        b, n = to_device(batch, device), to_device(noise, device)
        s = cfg_s if gamma is None else cfg_s[:5] + (gamma,) + cfg_s[6:]
        f = partial(_dreamer_update, cfg_s=s, tx_wm=algo.tx_wm,
                    tx_actor=algo.tx_actor, tx_critic=algo.tx_critic)
        first = []

        def step():
            record = None if first else []
            scale[0], metrics = f(params, target, *opts, scale[0], b, n,
                                  record=record)
            if record is not None:
                first.append(True)
                draws.append({
                    "device": str(device), "gamma": gamma,
                    "indices": [idx.cpu().numpy() for idx, _ in record],
                    "margin": min(float(m.min()) for _, m in record)})
            return [*metrics.values(), scale[0]]

        return step, lambda stats: rl_numpy([*stats, *leaves(params),
                                             *leaves(target)])

    return make


def check_rllib_dreamer(torch, smi: str) -> dict:
    """DreamerV3 at its defaults on CartPole-v1 (h_dim 128, 8 categoricals
    of 8, batch 8 of sequences of 16, horizon 8, 128 steps an iteration,
    learning_starts 256, 4 updates an iteration) on the card,
    RL_REPLAY_ITERS iterations of which two update; then one update from
    the trained state on a replay batch with the same Gumbel draws, the
    card's against the CPU's (every leaf, the target, the return scale
    and the metrics; control: gamma 0.9), the sampled indices equal and
    the smallest sampling margin reported."""
    from ray_tpu_torch.rllib.dreamer import DreamerV3Config
    from ray_tpu_torch.rllib.sac import leaves

    algo = DreamerV3Config().build()
    cfg = algo.config
    run = rl_replay_iterations(
        torch, algo, leaves(algo.params),
        ("wm_loss", "actor_loss", "critic_loss", "imag_return_mean"),
        cfg.num_rollout_workers * cfg.rollout_fragment_length)
    batch = algo.buffer.sample(cfg.batch_size, cfg.seq_len,
                               np.random.default_rng(SEED))
    draws = []
    check = rl_fn_card_against_cpu(
        dreamer_make(algo, batch, algo._noise(), draws), {"gamma": 0.9})
    # the made updates in order: the card's, the CPU's, the control's
    card, cpu = draws[0], draws[1]
    same = all(np.array_equal(a, b) for a, b in zip(
        card["indices"], cpu["indices"], strict=True))
    check["sampled_indices_equal"] = same
    check["smallest_sampling_margin"] = {
        "card": card["margin"], "cpu": cpu["margin"]}
    emit("rllib_dreamer", card=smi, env=cfg.env, **run,
         card_against_cpu=check)
    if not same:
        raise AssertionError(f"a sampled index differs: {check}")
    return run["launches"]


def check_rllib(torch, smi: str) -> dict:
    """Every RLlib phase, the kernel counts of each."""
    t0 = time.perf_counter()
    counts = {"rllib_ppo_3_iterations": check_rllib_ppo(torch, smi),
              "rllib_bandit_7_iterations": check_rllib_bandit(torch, smi),
              "rllib_impala_3_iterations":
                  check_rllib_impala(torch, smi, "impala"),
              "rllib_appo_3_iterations":
                  check_rllib_impala(torch, smi, "appo"),
              "rllib_learners": check_rllib_learners(torch, smi),
              "rllib_dqn_3_iterations": check_rllib_dqn(torch, smi),
              **{f"rllib_{name}_3_iterations":
                 check_rllib_continuous(torch, smi, name)
                 for name in ("sac", "td3", "ddpg")},
              "rllib_offline": check_rllib_offline(torch, smi),
              # slice 15, each phase with its counts zeroed in it
              **check_rllib_recurrent(torch, smi),
              **check_rllib_multi_agent(torch, smi),
              "rllib_dreamer_3_iterations": check_rllib_dreamer(torch, smi)}
    emit("rllib_phases", seconds=time.perf_counter() - t0)
    return counts


# ---------------------------------------------------------------------------
# Tune (slice 13): PBT trials that train Llama-3-8B's widths on this card,
# the serve body LLMDeployment with the replica context, the quickstarts
# ---------------------------------------------------------------------------

# Each PBT trial is llama3_8b() at this depth: 1.27 B parameters, 10 GB of
# state (parameters, gradients, two moments), so two trials share the card;
# depth 1 since slice 18 (2 before), to keep the script inside its time
# limit as the cluster group joins it; 4 steps since slice 20 (6 before):
# a trial saves once (at step 2, 9 GB in 14-16 s), and the exploit at the
# last trial's first report restores its donor's step-2 checkpoint
TUNE_DEPTH = 1
TUNE_STEPS = 4
# one trial a learning rate, two at a time; the last barely trains, so it
# is the worst of the four when its wave is ranked against the first
TUNE_LRS = (3e-5, 1e-4, 3e-4, 1e-8)
# the batches' tokens come from this many ids: a unigram a few steps learn
TUNE_TOKEN_RANGE = 1024
TUNE_TOL = 1e-3
# the control (the restore skipped) must miss TUNE_TOL by this factor
TUNE_CONTROL_FACTOR = 10.0
# LLMDeployment: new tokens a request, one request at a time
DEPLOY_NEW_TOKENS = 8
# serve_run: two replicas of Llama-3-8B on the card, half its GPU resource
# each; the burst (also run on llm_deployment's single engine), and the
# prefix-affinity requests after the first one that makes a holder
SERVE_REPLICAS = 2
SERVE_BURST = 16
SERVE_BURST_PROMPT = 128
SERVE_BURST_TOKENS = 32
SERVE_AFFINITY_REQUESTS = 6
# the card's memory after the phase against before it
SERVE_MEMORY_TOL = 1 << 30


class TrialClock:
    """Tune callbacks that stamp each trial process's spawn and first
    report (a restarted trial is a new process: its ``run``)."""

    def __init__(self):
        self.spawned: dict = {}
        self.first_report: dict = {}

    def on_trial_start(self, trial):
        self.spawned.setdefault(trial.trial_id, []).append(
            time.perf_counter())

    def on_trial_result(self, trial, result):
        key = (trial.trial_id, result["run"])
        if key not in self.first_report:
            self.first_report[key] = time.perf_counter() - \
                self.spawned[trial.trial_id][-1]


class MemWatch:
    """The host's least available memory and most shared memory (the
    trials' checkpoints in /dev/shm) while it runs, from /proc/meminfo
    every 0.25 s."""

    def __init__(self):
        import threading

        self.least_available = self.most_shmem = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _read(self) -> dict:
        with open("/proc/meminfo") as f:
            return {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f}

    def _run(self):
        while not self._stop.wait(0.25):
            m = self._read()
            avail, shm = m["MemAvailable"], m["Shmem"]
            if self.least_available is None or avail < self.least_available:
                self.least_available = avail
            if self.most_shmem is None or shm > self.most_shmem:
                self.most_shmem = shm

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def tune_base() -> dict:
    return {"preset": "llama3_8b", "n_layers": TUNE_DEPTH,
            "steps": TUNE_STEPS,
            "report_every": 2, "batch_size": 2, "seq_len": 2048,
            "token_range": TUNE_TOKEN_RANGE, "seed": SEED}


def check_tune_pbt(torch, smi: str) -> dict:
    """``Tuner`` with ``PopulationBasedTraining`` over ``learning_rate``
    (``ray_tpu_torch/examples/tune_llama.py``): 4 trials of llama3_8b() at
    TUNE_DEPTH, two at a time, each one NCCL rank on this card training
    TUNE_STEPS steps on [2, 2049] batches keyed by the step, reporting
    every 2 steps with a checkpoint (none after the last). Held: every trial TERMINATED; at least one
    exploit; an exploited trial's first loss within TUNE_TOL (relative)
    of its donor's at that step; the control, the same trial's config
    started at that step without the restore (here, in the parent, after
    the trials), misses TUNE_TOL by TUNE_CONTROL_FACTOR; every step of
    every trial launched K1 2 and the backward 1 a layer (remat "full"),
    counted in the trial's rank. Returns one step's counts."""
    import tempfile

    from ray_tpu_torch.examples import tune_llama

    t0 = time.perf_counter()
    clock = TrialClock()
    base = tune_base()
    # the checkpoints (9 GB each; each trial keeps its newest) go to
    # shared memory: the card's machine takes at most 45 GiB of writes to
    # its disk in a run, and the rest of this script writes most of that
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as d, MemWatch() as mem:
        grid = tune_llama.pbt_tuner(base, TUNE_LRS, storage_path=d,
                                    callbacks=[clock]).fit()
        fit_s = time.perf_counter() - t0
        found = tune_llama.exploits(grid)
        controls = []
        for trial, donor, step, loss, want in found:
            trainer = tune_llama.trial_trainer(trial.config, "cuda")
            state = tune_llama.trial_start(trainer, trial.config, None,
                                           "cuda")
            _, m = trainer.train_step(state, tune_llama.trial_batch(
                trial.config, step, "cuda"))
            controls.append(float(m["loss"]))
            del trainer, state, m
            free_card(torch)
    results = [r for t in grid for r in t.results]
    step_counts = [{"flash_fwd": f, "flash_bwd": b} for r in results
                   for f, b in zip(r["launches"]["flash_fwd"],
                                   r["launches"]["flash_bwd"])]
    want_counts = {"flash_fwd": 2 * TUNE_DEPTH, "flash_bwd": TUNE_DEPTH}
    # a process's first step carries its start-up (cuBLAS, allocations)
    steady = [s for r in results for s in r["step_s"][1:]]
    exploits = [{"trial": t.trial_id, "donor": donor.trial_id, "step": step,
                 "first_loss": loss, "donor_loss": want,
                 "rel_err": abs(loss - want) / abs(want),
                 "control_loss": c, "control_rel_err": abs(c - want) / abs(want),
                 "explored_learning_rate": t.config["learning_rate"]}
                for (t, donor, step, loss, want), c in zip(found, controls)]
    restores = [r["restore_s"] for r in results if r["restore_s"]]
    emit("tune_pbt", nvidia_smi=smi, config="llama3_8b", n_layers=TUNE_DEPTH,
         depth_cut=f"32 -> {TUNE_DEPTH} layers: two trials' states (10 GB "
                   "each) share the card",
         tokens=[base["batch_size"], base["seq_len"] + 1],
         token_range=base["token_range"], learning_rates=list(TUNE_LRS),
         trials=[{"trial": t.trial_id, "status": t.status,
                  "learning_rate": t.config["learning_rate"],
                  "reports": [(r["run"], r["step"], r["losses"])
                              for r in t.results]} for t in grid],
         exploits=exploits, tol=TUNE_TOL,
         control_factor=TUNE_CONTROL_FACTOR,
         spawn_to_first_report_s={f"{k[0]}@{k[1]}": v
                                  for k, v in clock.first_report.items()},
         step_s_median=float(np.median(steady)), step_s=steady,
         restore_s=restores,
         save_s=[r["save_s"] for r in results if r["save_s"]],
         launches_a_step=step_counts[0] if step_counts else None,
         checkpoint_dir=shm or tempfile.gettempdir(),
         host_least_available_bytes=mem.least_available,
         host_most_shmem_bytes=mem.most_shmem,
         fit_s=fit_s, seconds=time.perf_counter() - t0)
    bad = [t.trial_id for t in grid if t.status != "TERMINATED"]
    if bad:
        errors = {t.trial_id: t.error for t in grid if t.error}
        raise AssertionError(f"tune_pbt trials {bad} did not terminate: "
                             f"{errors}")
    if not exploits:
        raise AssertionError("tune_pbt: no trial was exploited")
    for e in exploits:
        if e["rel_err"] > TUNE_TOL or \
                e["control_rel_err"] < TUNE_CONTROL_FACTOR * TUNE_TOL:
            raise AssertionError(
                f"tune_pbt exploit {e}: the first loss must sit within "
                f"{TUNE_TOL} of the donor's and the control miss it by "
                f"{TUNE_CONTROL_FACTOR}x")
    if not step_counts or any(c != want_counts for c in step_counts):
        raise AssertionError(f"tune_pbt launches a step {step_counts}, want "
                             f"{want_counts}")
    return step_counts[0]


def serve_prompts(cfg) -> tuple:
    """The serve phase's prompts: 8 of 128 tokens, then a shared 512-token
    prefix with two 40-token tails."""
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, 128) for _ in range(8)]
    shared = rng.integers(1, cfg.vocab_size, 512)
    tails = [rng.integers(1, cfg.vocab_size, 40) for _ in range(2)]
    return prompts, shared, tails


def burst_prompts(cfg) -> list:
    """The burst's prompts: SERVE_BURST of SERVE_BURST_PROMPT tokens."""
    rng = np.random.default_rng(SEED + 3)
    return [rng.integers(1, cfg.vocab_size, SERVE_BURST_PROMPT)
            for _ in range(SERVE_BURST)]


def check_burst(outs, vocab_size: int):
    """Every burst request got SERVE_BURST_TOKENS ids inside the
    vocabulary."""
    if [len(o) for o in outs] != [SERVE_BURST_TOKENS] * SERVE_BURST:
        raise AssertionError(f"burst token counts {[len(o) for o in outs]}")
    if not all(0 <= t < vocab_size for o in outs for t in o):
        raise AssertionError("burst token id out of range")


def check_llm_deployment(torch, cfg, params, smi: str) -> tuple:
    """``LLMDeployment`` over llama3_8b() at full depth, paged, built from
    the weights already on the card: the serve phase's prompts one after
    another, DEPLOY_NEW_TOKENS greedy tokens each, bit for bit against a
    ``PagedLLMEngine`` of the same settings fed the same way (one request
    at a time: an engine's batches change its GEMMs' shapes, so only the
    same arrivals promise the same bits); then the burst (SERVE_BURST
    requests at once) on the same engine, the single-engine numbers
    ``serve_run`` compares with; then a deployment built under
    ``set_replica_context``, whose engine carries the tags, on the first
    two prompts. Returns the kernel counts (the engines run no K1), the
    reference tokens and the burst's numbers."""
    from ray_tpu_torch.serve.context import set_replica_context
    from ray_tpu_torch.serve.llm import LLMDeployment
    from ray_tpu_torch.serve.paged_llm import PagedLLMEngine

    prompts, shared, tails = serve_prompts(cfg)
    prompts = prompts + [np.concatenate([shared, t]) for t in tails]
    kw = {"max_batch": 8, "max_len": 2048, "page_size": 128,
          "decode_chunk": DEPLOY_NEW_TOKENS}
    t0 = time.perf_counter()
    zero_counts()
    eng = PagedLLMEngine(cfg, params, **kw)
    eng.start()
    try:
        want = [list(eng.submit(p, max_new_tokens=DEPLOY_NEW_TOKENS).tokens())
                for p in prompts]
    finally:
        eng.stop()
    del eng
    free_card(torch)
    engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dep = LLMDeployment(lambda: (cfg, params), kv_layout="paged", **kw)
    try:
        got = [dep(p, max_new_tokens=DEPLOY_NEW_TOKENS) for p in prompts]
        stats = dep.stats()
        plain_tags = (dep._engine.deployment_name, dep._engine.replica_tag)
        t1 = time.perf_counter()
        reqs = [dep._engine.submit(p, max_new_tokens=SERVE_BURST_TOKENS)
                for p in burst_prompts(cfg)]
        outs = [list(r.tokens()) for r in reqs]
        burst_wall = time.perf_counter() - t1
        chunk_period = dep._engine._chunk_period
    finally:
        dep._engine.stop()
    check_burst(outs, cfg.vocab_size)
    burst = {"requests": SERVE_BURST, "prompt_tokens": SERVE_BURST_PROMPT,
             "new_tokens_each": SERVE_BURST_TOKENS, "wall_s": burst_wall,
             "tokens_per_s": SERVE_BURST * SERVE_BURST_TOKENS / burst_wall,
             "p50_ttft_s": float(np.median([r.ttft for r in reqs])),
             "max_ttft_s": float(max(r.ttft for r in reqs)),
             "chunk_period_s": chunk_period}
    del dep
    free_card(torch)
    deploy_s = time.perf_counter() - t0
    set_replica_context("llama3_8b", "llama3_8b#0")
    try:
        tagged = LLMDeployment(lambda: (cfg, params), kv_layout="paged", **kw)
    finally:
        set_replica_context(None, None)
    try:
        got_tagged = [tagged(p, max_new_tokens=DEPLOY_NEW_TOKENS)
                      for p in prompts[:2]]
        tags = (tagged._engine.deployment_name, tagged._engine.replica_tag)
    finally:
        tagged._engine.stop()
    del tagged
    free_card(torch)
    counts = launch_counts()
    hits = stats["prefix_cache"]["hit_pages"]
    emit("llm_deployment", nvidia_smi=smi, config="llama3_8b",
         n_layers=cfg.n_layers, kv_layout="paged", **kw,
         requests=len(prompts), new_tokens_each=DEPLOY_NEW_TOKENS,
         tokens_equal=got == want,
         first_mismatch=next((i for i, (g, w) in enumerate(zip(got, want))
                              if g != w), None),
         tagged_tokens_equal=got_tagged == want[:2], tags=list(tags),
         untagged_tags=list(plain_tags), prefix_hit_pages=hits,
         stats_keys=sorted(stats), engine_s=engine_s, deployment_s=deploy_s,
         burst=burst, launches=counts)
    if got != want or got_tagged != want[:2]:
        raise AssertionError("LLMDeployment's greedy tokens differ from "
                             "PagedLLMEngine's")
    if tags != ("llama3_8b", "llama3_8b#0") or plain_tags[0] != "-":
        raise AssertionError(f"engine tags {tags}, untagged {plain_tags}")
    if hits <= 0:
        raise AssertionError(f"the deployment's prefix cache never hit: "
                             f"{stats}")
    return counts, want, burst


_SERVE_MODEL: dict = {}


def serve_model():
    """serve_run's model builder, a module-level function: the weights
    already on the card. The in-process runtime hands the builder to each
    replica by reference, so both engines hold the one set of weights and
    nothing is pickled or copied."""
    return _SERVE_MODEL["cfg"], _SERVE_MODEL["params"]


class LLMIngress:
    """serve_run's HTTP face, composed over the LLM deployment: the proxy
    hands a deployment its JSON body as one argument, so a body
    ``{"prompt": [...], "max_new_tokens": n}`` becomes one call of the
    deployment's handle, routed by the prompt's prefix."""

    def __init__(self, llm):
        # the handle's prefix router imports torch: in a worker process of
        # the cluster, here while the LLM replicas start, not in the first
        # request
        from ray_tpu_torch.serve import prefix_router  # noqa: F401

        self.llm = llm

    def __call__(self, payload):
        prompt = [int(t) for t in payload["prompt"]]
        return self.llm.call(prompt,
                             max_new_tokens=int(payload["max_new_tokens"]),
                             _prefix_tokens=prompt)


def replica_engines(core, live=True) -> dict:
    """The engines of the runtime's LLM replicas (only the live ones with
    ``live``), by replica tag: the in-process runtime holds each replica's
    instance."""
    out = {}
    for state in list(core.get_runtime()._actors.values()):
        body = getattr(state.instance, "_instance", None)
        if hasattr(body, "_engine") and not (live and state.dead):
            out[state.instance._tag] = body._engine
    return out


def stop_replica_engines(core, timeout: float = 120.0) -> int:
    """Stop the engine of every LLM replica the runtime holds, live or
    killed, after any replica still building its engine (a replacement
    the controller spawned) has built it: a killed replica's engine keeps
    running in the in-process runtime, as in JAX. Returns how many."""
    deadline = time.monotonic() + timeout
    while any(s.instance is None and s.creation_spec is not None
              and s.creation_spec.function_name == "_Replica.__init__"
              and not s.death_reason.startswith("__init__ failed")
              for s in list(core.get_runtime()._actors.values())):
        if time.monotonic() > deadline:
            raise AssertionError("a replica never finished building")
        time.sleep(0.05)
    engines = replica_engines(core, live=False)
    for eng in engines.values():
        eng.stop()
    return len(engines)


class EngineLoad:
    """The most requests the engines held at once (active and waiting),
    sampled every 10 ms while it runs."""

    def __init__(self, engines: dict):
        import threading

        self.engines, self.most = engines, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.01):
            held = sum(sum(r is not None for r in e._active)
                       + e._waiting.qsize() for e in self.engines.values())
            self.most = max(self.most, held)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.engines = None   # the card's memory goes with the engines


def hit_pages(engines: dict) -> dict:
    return {t: e.stats()["prefix_cache"]["hit_pages"]
            for t, e in engines.items()}


def check_serve_run(torch, cfg, params, smi: str, want: list,
                    single_burst: dict) -> dict:
    """Serve on the port's in-process runtime: ``serve.run`` of two
    ``LLMDeployment`` replicas of llama3_8b() at full depth on this card
    (half its GPU resource each, one set of weights), behind an ingress
    deployment. The serve phase's ten prompts through the handle one at a
    time, bit for bit ``check_llm_deployment``'s reference tokens; one
    through the HTTP proxy; prefix affinity (a fresh 512-token prefix,
    then SERVE_AFFINITY_REQUESTS requests carrying it: the holder's hit
    pages grow by the prefix's 4 pages each, the other's not at all; a
    control whose first page differs scores 0 at ``PrefixRouter`` and
    fails that check); the burst across the replicas beside the single
    engine's. A killed replica's engine keeps running in the in-process
    runtime (as in JAX), so the phase stops the engines through the
    replicas' instances before it shuts Serve down, and the card's memory
    must come back within SERVE_MEMORY_TOL. Returns the kernel counts and
    the burst's numbers."""
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.runtime import annex, core
    from ray_tpu_torch.serve.llm import LLMDeployment
    from ray_tpu_torch.serve.prefix_router import (DIGEST_PREFIX,
                                                   PrefixRouter,
                                                   digest_hashes)
    from ray_tpu_torch.utils.config import get_config

    t_phase = time.perf_counter()
    prompts, shared, tails = serve_prompts(cfg)
    prompts = prompts + [np.concatenate([shared, t]) for t in tails]
    kw = {"max_batch": 8, "max_len": 2048, "page_size": 128,
          "decode_chunk": DEPLOY_NEW_TOKENS, "device": "cuda:0"}
    free_card(torch)
    mem_before = torch.cuda.memory_allocated()
    weights_bytes = storage_bytes([t for _, t in named_leaves(params)])
    _SERVE_MODEL.update(cfg=cfg, params=params)
    zero_counts()
    ray_tpu_torch.init()
    out = {"memory_before": mem_before, "weights_bytes": weights_bytes}
    try:
        out["cluster_gpus"] = ray_tpu_torch.cluster_resources()["GPU"]
        llm = serve.deployment(
            LLMDeployment, num_replicas=SERVE_REPLICAS,
            resources_per_replica={"GPU": 1 / SERVE_REPLICAS}).bind(
                serve_model, **kw)
        t0 = time.perf_counter()
        serve.run(serve.deployment(LLMIngress).bind(llm))
        deadline = time.monotonic() + 300
        while len(replica_engines(core)) < SERVE_REPLICAS:
            if time.monotonic() > deadline:
                raise AssertionError("the LLM replicas never came up")
            time.sleep(0.05)
        engines = replica_engines(core)
        torch.cuda.synchronize()
        out["up_s"] = time.perf_counter() - t0
        out["memory_up"] = torch.cuda.memory_allocated()
        out["pool_bytes"] = sum(x.numel() * x.element_size()
                                for e in engines.values()
                                for x in e._pools)
        out["gpu_available_up"] = ray_tpu_torch.available_resources()["GPU"]
        out["tags"] = sorted(engines)
        handle = serve.get_deployment_handle("LLMDeployment")

        # sequential: the reference engine's arrivals, one at a time;
        # _prefix_tokens sends the second shared-prefix prompt where the
        # first left its pages, as it was on the reference engine
        fin0 = {t: e.total_finished for t, e in engines.items()}
        t0 = time.perf_counter()
        got = [handle.call(p, max_new_tokens=DEPLOY_NEW_TOKENS,
                           _prefix_tokens=[int(x) for x in p])
               for p in prompts]
        out["sequential"] = {
            "requests": len(prompts), "seconds": time.perf_counter() - t0,
            "tokens_equal": got == want,
            "first_mismatch": next((i for i, (g, w) in enumerate(
                zip(got, want)) if g != w), None),
            "share": {t: e.total_finished - fin0[t]
                      for t, e in engines.items()}}

        server, (host, port) = serve.start_http_proxy()
        try:
            t0 = time.perf_counter()
            body = json.dumps({"prompt": [int(x) for x in prompts[0]],
                               "max_new_tokens": DEPLOY_NEW_TOKENS}).encode()
            req = urllib.request.Request(
                f"http://{host}:{port}/LLMIngress", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                http = json.load(resp)["result"]
            out["http"] = {"tokens_equal": http == want[0],
                           "seconds": time.perf_counter() - t0}
        finally:
            server.shutdown()
            server.server_close()

        # prefix affinity on a prefix no replica holds yet: its first
        # request goes by power-of-two choices and makes the holder
        rng = np.random.default_rng(SEED + 2)
        prefix = rng.integers(1, cfg.vocab_size, 512)
        aff = [np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 40)])
               for _ in range(SERVE_AFFINITY_REQUESTS + 1)]
        t0 = time.perf_counter()
        handle.call(aff[0], max_new_tokens=DEPLOY_NEW_TOKENS)
        time.sleep(get_config().serve_digest_publish_interval_s)
        chain = set(digest_hashes(prefix, kw["page_size"]))
        holders = sorted(
            r["payload"]["tag"]
            for r in annex.cluster_metric_annexes(DIGEST_PREFIX)
            if chain <= set(r["payload"]["hashes"]))
        if len(holders) != 1:
            raise AssertionError(f"prefix holders {holders}")
        holder = holders[0]
        other = next(t for t in engines if t != holder)
        hits = hit_pages(engines)
        grew = []
        for p in aff[1:]:
            handle.call(p, max_new_tokens=DEPLOY_NEW_TOKENS,
                        _prefix_tokens=[int(x) for x in p])
            now = hit_pages(engines)
            grew.append({t: now[t] - hits[t] for t in (holder, other)})
            hits = now
        pages = len(chain)

        def affine(d):
            return d[holder] >= pages and d[other] == 0

        # control: one token of the first page changed
        control = aff[1].copy()
        control[0] = control[0] % (cfg.vocab_size - 1) + 1
        router = PrefixRouter()
        router.ingest(annex.cluster_metric_annexes(DIGEST_PREFIX))
        ctl = [int(x) for x in control]
        handle.call(control, max_new_tokens=DEPLOY_NEW_TOKENS,
                    _prefix_tokens=ctl)
        now = hit_pages(engines)
        control_grew = {t: now[t] - hits[t] for t in (holder, other)}
        out["affinity"] = {
            "holder": holder, "prefix_pages": pages, "hit_pages_grew": grew,
            "holder_only": all(affine(d) for d in grew),
            "score_at_holder": router.score([int(x) for x in aff[1]],
                                            holder),
            "control_score_at_holder": router.score(ctl, holder),
            "control_pick": router.pick(ctl, {holder: 0, other: 0}),
            "control_hit_pages_grew": control_grew,
            "control_passes": affine(control_grew),
            "seconds": time.perf_counter() - t0}

        # the burst: every request at once, across the replicas
        bprompts = burst_prompts(cfg)
        fin0 = {t: e.total_finished for t, e in engines.items()}
        n_ttft = {t: len(e.ttfts) for t, e in engines.items()}
        t0 = time.perf_counter()
        refs = [handle.remote(p, max_new_tokens=SERVE_BURST_TOKENS)
                for p in bprompts]
        latency, pending = [], list(refs)
        with EngineLoad(engines) as load:
            while pending:
                ready, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                                    timeout=300)
                if not ready:
                    raise AssertionError("the burst stalled")
                latency.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        outs = ray_tpu_torch.get(refs)
        check_burst(outs, cfg.vocab_size)
        ttfts = [x for t, e in engines.items()
                 for x in list(e.ttfts)[n_ttft[t]:]]
        tps = SERVE_BURST * SERVE_BURST_TOKENS / wall
        out["burst"] = {
            "requests": SERVE_BURST, "prompt_tokens": SERVE_BURST_PROMPT,
            "new_tokens_each": SERVE_BURST_TOKENS, "wall_s": wall,
            "tokens_per_s": tps, "p50_ttft_s": float(np.median(ttfts)),
            "max_ttft_s": float(max(ttfts)),
            "p50_latency_s": float(np.median(latency)),
            "share": {t: e.total_finished - fin0[t]
                      for t, e in engines.items()},
            "in_engines_most": load.most,
            "chunk_period_s": {t: e._chunk_period
                               for t, e in engines.items()},
            "single_engine": single_burst,
            "tokens_per_s_over_single": tps / single_burst["tokens_per_s"]}
        out["failover"] = ray_tpu_torch.get(ray_tpu_torch.get_actor(
            serve.api.CONTROLLER_NAME).failover_stats.remote())
    finally:
        engines = handle = None
        serve.shutdown()
        time.sleep(0.2)   # the control loop ends its last pass
        out["engines_stopped"] = stop_replica_engines(core)
        ray_tpu_torch.shutdown()
        _SERVE_MODEL.clear()
        free_card(torch)
    out["memory_after"] = torch.cuda.memory_allocated()
    counts = launch_counts()
    out["seconds"] = time.perf_counter() - t_phase
    emit("serve_run", nvidia_smi=smi, config="llama3_8b",
         n_layers=cfg.n_layers, replicas=SERVE_REPLICAS,
         gpu_per_replica=1 / SERVE_REPLICAS,
         **{k: v for k, v in kw.items() if k != "device"}, **out,
         launches=counts)
    if not out["sequential"]["tokens_equal"] or not out["http"][
            "tokens_equal"]:
        raise AssertionError("tokens through Serve differ from the "
                             "reference engine's")
    a = out["affinity"]
    if not a["holder_only"] or a["score_at_holder"] != a["prefix_pages"]:
        raise AssertionError(f"prefix affinity: {a}")
    if a["control_score_at_holder"] != 0 or a["control_pick"] is not None \
            or a["control_passes"]:
        raise AssertionError(f"the affinity control did not fail: {a}")
    if sorted(out["burst"]["share"].values()) == [0, SERVE_BURST] or \
            sum(out["burst"]["share"].values()) != SERVE_BURST:
        raise AssertionError(f"burst shares {out['burst']['share']}")
    if out["memory_up"] - mem_before > out["pool_bytes"] + SERVE_MEMORY_TOL:
        raise AssertionError(
            f"serve.run took {out['memory_up'] - mem_before} bytes of the "
            f"card for {out['pool_bytes']} bytes of KV pools: the weights "
            "were copied")
    if abs(out["memory_after"] - mem_before) > SERVE_MEMORY_TOL:
        raise AssertionError(f"the card held {mem_before} bytes before the "
                             f"phase and {out['memory_after']} after")
    if counts != {"flash_fwd": 0, "flash_bwd": 0}:
        raise AssertionError(f"the serve engines launched {counts}")
    return counts, out["burst"]


# ---------------------------------------------------------------------------
# the cluster runtime on one host (slice 18): the port's own GCS and raylet
# in this process, tasks and actors in worker processes on this card
# ---------------------------------------------------------------------------

# K1's inputs in the worker: b, h, hk, s, d (Llama-3-8B's attention)
CLUSTER_K1_SHAPE = (1, 32, 8, 2048, 128)
# the tensor that goes through put and get across the process boundary
CLUSTER_PUT_BYTES = 1 << 30
# the node's shared-memory store: the tensor in, its copy back, headroom
CLUSTER_STORE_BYTES = 4 << 30
# a request that holds one replica while the shared-prefix pair goes to
# the other by power-of-two choices
CLUSTER_HOLD_TOKENS = 128


def cluster_k1_inputs(torch) -> tuple:
    """The seeded K1 inputs of cluster_task, on this process's card, in
    the kernel layout: q [b, h, s, d], k and v [b, hk, s, d], bf16."""
    b, h, hk, s, d = CLUSTER_K1_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    return randn(b, h, s, d), randn(b, hk, s, d), randn(b, hk, s, d)


def process_report() -> dict:
    """This process's pid and whether it loaded JAX, the JAX package or
    cloudpickle."""
    mods = list(sys.modules)
    return {"pid": os.getpid(),
            "jax": sorted(m for m in mods
                          if m == "jax" or m.startswith("jax.")),
            "ray_tpu": sorted(m for m in mods
                              if m == "ray_tpu" or m.startswith("ray_tpu.")),
            "cloudpickle": "cloudpickle" in sys.modules}


def cluster_k1_task() -> dict:
    """cluster_task's task, run in a worker process: K1 on the seeded
    inputs, its output returned as a CUDA tensor, the process's report
    and its K1 launches."""
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_fwd

    zero_counts()
    q, k, v = cluster_k1_inputs(torch)
    out, _ = flash_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    return {"out": out, "launches": launch_counts(), **process_report(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def cluster_echo_task(refs: list) -> dict:
    """The 1 GiB tensor's trip: ``get`` of the driver's put in this worker
    process (timed here), then the tensor back as the task's return."""
    import torch

    import ray_tpu_torch

    t0 = time.perf_counter()
    x = ray_tpu_torch.get(refs[0])
    torch.cuda.synchronize()
    return {"x": x, "get_s": time.perf_counter() - t0,
            "device": str(x.device), "pid": os.getpid()}


def leaf_checksums(params, chunk: int = 1 << 26) -> dict:
    """Per leaf: the sum and the sum of squares of its bf16 bit patterns
    as int64 (equal sums for equal bits), a chunk of elements at a time
    (a whole block stack in int64 would take 15 GB)."""
    import torch

    out = {}
    for name, t in named_leaves(params):
        flat = t.detach().reshape(-1).view(torch.int16)
        s = q = 0
        for i in range(0, flat.numel(), chunk):
            bits = flat[i:i + chunk].to(torch.int64)
            s += int(bits.sum())
            q += int((bits * bits).sum())
        out[name] = [s, q]
    return out


def cluster_serve_model():
    """cluster_serve's model builder, reached by each replica by
    reference: Llama-3-8B at full width and depth, its weights built in
    the replica's own process from the serve phase's seed."""
    from ray_tpu_torch.models import llama

    cfg = llama.llama3_8b()
    return cfg, llama.init_params(cfg, seed=SEED, device="cuda")


def _cluster_llm_class():
    from ray_tpu_torch.serve.llm import LLMDeployment

    class ClusterLLM(LLMDeployment):
        """``LLMDeployment`` that also reports its process: pid, the
        modules it loaded, its weights' checksums and its engine's
        numbers."""

        def replica_info(self, checksums: bool = False) -> dict:
            e = self._engine
            return {**process_report(),
                    "checksums": leaf_checksums(e.params) if checksums
                    else None,
                    "total_finished": e.total_finished,
                    "ttfts": list(e.ttfts),
                    "chunk_period_s": e._chunk_period,
                    "hit_pages": e.stats()["prefix_cache"]["hit_pages"]}

    ClusterLLM.__module__ = __name__
    ClusterLLM.__qualname__ = "ClusterLLM"
    return ClusterLLM


def __getattr__(name):
    # ClusterLLM subclasses the port's LLMDeployment, so it is made at
    # first use: this file imports nothing of the port at import time.
    # Made once a process, under its module name, so pickle carries it by
    # reference to the replicas (which import this file as __mp_main__).
    if name == "ClusterLLM":
        globals()[name] = cls = _cluster_llm_class()
        return cls
    if name == "CliLLMHttp":
        # the bound deployment that cli_serve's config names
        globals()[name] = dep = _cli_llm_http()
        return dep
    raise AttributeError(name)


def smi_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory``'s rows. In a
    container the pid and memory columns may not be the process's own (a
    sealed machine printed pid 1 and the card's total on every row), so
    the rows are counted, one a process with a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def zombie(pid: int) -> bool:
    """Whether process ``pid`` exited and waits for its parent to reap
    it."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] == "Z"
    except OSError:
        return False


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def check_cluster_task(torch, ray_tpu_torch, smi: str) -> dict:
    """cluster_task: a ``num_gpus=1`` task in a worker process launches K1
    on the seeded inputs and returns its output as a CUDA tensor, held bit
    for bit against this process's K1 on the same inputs (control: the
    non-causal output must fail); the worker reports its pid, its modules
    and one launch. Then a 1 GiB bf16 tensor of this card through ``put``,
    a worker's ``get`` and the task's return, bit for bit."""
    from ray_tpu_torch.ops.flash_attention import flash_fwd

    t_phase = time.perf_counter()
    k1 = ray_tpu_torch.remote(num_gpus=1)(cluster_k1_task)
    t0 = time.perf_counter()
    rep = ray_tpu_torch.get(k1.remote(), timeout=300)
    task_s = time.perf_counter() - t0
    q, k, v = cluster_k1_inputs(torch)
    want, _ = flash_fwd(q, k, v, causal=True)
    control, _ = flash_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    got = rep.pop("out")
    out = {"task_s": task_s, "worker": rep, "driver_pid": os.getpid(),
           "out_device": str(got.device), "out_shape": list(got.shape),
           "bits_equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "control_bits_equal": bool(torch.equal(got, control))}
    del q, k, v, want, control, got
    # the 1 GiB trip
    x = torch.randn(CLUSTER_PUT_BYTES // 2, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 19)).to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ray_tpu_torch.put(x)
    put_s = time.perf_counter() - t0
    echo = ray_tpu_torch.remote(num_gpus=1)(cluster_echo_task)
    t0 = time.perf_counter()
    back_ref = echo.remote([ref])
    ray_tpu_torch.wait([back_ref], timeout=300)
    task_done_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ray_tpu_torch.get(back_ref)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    y = back.pop("x")
    out["transfer"] = {
        "bytes": x.numel() * x.element_size(), "dtype": str(x.dtype),
        "put_s": put_s, "worker_get_s": back["get_s"],
        "worker_device": back["device"], "worker_pid": back["pid"],
        "task_s": task_done_s, "driver_get_s": get_s,
        "bits_equal": bool(torch.equal(x, y)), "device": str(y.device)}
    del x, y, ref, back_ref
    free_card(torch)
    out["seconds"] = time.perf_counter() - t_phase
    emit("cluster_task", nvidia_smi=smi, shape=list(CLUSTER_K1_SHAPE), **out)
    w = out["worker"]
    if not out["bits_equal"] or out["control_bits_equal"]:
        raise AssertionError(f"the worker's K1 output: bits equal "
                             f"{out['bits_equal']}, control equal "
                             f"{out['control_bits_equal']}")
    if w["pid"] == os.getpid() or w["jax"] or w["ray_tpu"] or \
            w["cloudpickle"]:
        raise AssertionError(f"the worker process: {w}")
    if w["launches"] != {"flash_fwd": 1, "flash_bwd": 0}:
        raise AssertionError(f"the worker launched {w['launches']}")
    t = out["transfer"]
    if not t["bits_equal"] or t["worker_pid"] == os.getpid() or \
            not t["device"].startswith("cuda") or \
            not t["worker_device"].startswith("cuda"):
        raise AssertionError(f"the 1 GiB tensor's trip: {t}")
    return w["launches"], out["task_s"]


def check_cluster_serve(torch, ray_tpu_torch, cfg, params, smi: str,
                        want: list, in_process_burst: dict) -> dict:
    """cluster_serve: ``serve.run`` of two ``LLMDeployment`` replicas of
    llama3_8b() at full width and depth behind the ingress deployment on
    the cluster, each replica an actor in its own worker process that
    builds its own weights from the seed (``cluster_serve_model``),
    ``resources_per_replica={"GPU": 0.5}``. Each replica's per-leaf
    checksums against this process's weights; the ten prompts through the
    handle bit for bit ``check_llm_deployment``'s reference tokens (the
    shared-prefix pair on one replica, as on the reference engine, by
    power-of-two choices while a long request holds the other: prefix
    digests stay in the replicas' processes), a one-token-changed control
    that must fail; one request over HTTP; the burst across the two
    processes beside serve_run's in-process figures."""
    import urllib.request

    from ray_tpu_torch import serve

    t_phase = time.perf_counter()
    prompts, shared, tails = serve_prompts(cfg)
    prompts = prompts + [np.concatenate([shared, t]) for t in tails]
    kw = {"max_batch": 8, "max_len": 2048, "page_size": 128,
          "decode_chunk": DEPLOY_NEW_TOKENS, "device": "cuda:0"}
    out = {}
    cls = getattr(sys.modules[__name__], "ClusterLLM")
    llm = serve.deployment(
        cls, name="LLMDeployment", num_replicas=SERVE_REPLICAS,
        resources_per_replica={"GPU": 1 / SERVE_REPLICAS}).bind(
            cluster_serve_model, **kw)
    t0 = time.perf_counter()
    serve.run(serve.deployment(LLMIngress).bind(llm))
    handle = serve.get_deployment_handle("LLMDeployment")
    controller = ray_tpu_torch.get_actor(serve.api.CONTROLLER_NAME)

    def replicas() -> list:
        _, table = ray_tpu_torch.get(
            controller.get_routing_table.remote("LLMDeployment"))
        return table

    def infos(checksums: bool = False) -> dict:
        return {e["tag"]: ray_tpu_torch.get(
                    e["replica"].handle_request.remote(
                        "replica_info", (checksums,), {}), timeout=600)
                for e in replicas()}

    info = infos(checksums=True)
    out["up_s"] = time.perf_counter() - t0
    want_sums = leaf_checksums(params)
    out["replica_processes"] = {t: {"pid": i["pid"], "jax": i["jax"],
                           "ray_tpu": i["ray_tpu"],
                           "cloudpickle": i["cloudpickle"],
                           "checksums_equal": i["checksums"] == want_sums}
                       for t, i in info.items()}
    out["gpu_available_up"] = ray_tpu_torch.available_resources()["GPU"]
    mem_up = torch.cuda.mem_get_info()[0]
    out["smi_apps_up"] = smi_apps()

    # sequential: prompts 1-8 one at a time; then a long request holds one
    # replica while the shared-prefix pair goes to the other, where the
    # second hits the first's pages as on the reference engine
    got = [handle.call(p, max_new_tokens=DEPLOY_NEW_TOKENS)
           for p in prompts[:8]]
    rng = np.random.default_rng(SEED + 4)
    hold = handle.remote(rng.integers(1, cfg.vocab_size, 128),
                         max_new_tokens=CLUSTER_HOLD_TOKENS)
    before = infos()
    got += [handle.call(p, max_new_tokens=DEPLOY_NEW_TOKENS)
            for p in prompts[8:]]
    after = infos()
    ready, _ = ray_tpu_torch.wait([hold], timeout=0)
    ray_tpu_torch.get(hold, timeout=600)
    pair = {t: after[t]["total_finished"] - before[t]["total_finished"]
            for t in after}
    ctl = [list(x) for x in want]
    ctl[0][0] = (ctl[0][0] + 1) % cfg.vocab_size
    out["sequential"] = {
        "requests": len(prompts), "tokens_equal": got == want,
        "first_mismatch": next((i for i, (g, w) in enumerate(
            zip(got, want)) if g != w), None),
        "pair_share": pair, "hold_done_before_pair_ended": bool(ready),
        "pair_hit_pages": {t: after[t]["hit_pages"] - before[t]["hit_pages"]
                           for t in after},
        "control_tokens_equal": got == ctl}

    server, (host, port) = serve.start_http_proxy()
    try:
        t0 = time.perf_counter()
        body = json.dumps({"prompt": [int(x) for x in prompts[0]],
                           "max_new_tokens": DEPLOY_NEW_TOKENS}).encode()
        req = urllib.request.Request(
            f"http://{host}:{port}/LLMIngress", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            http = json.load(resp)["result"]
        out["http"] = {"tokens_equal": http == want[0],
                       "seconds": time.perf_counter() - t0}
    finally:
        server.shutdown()
        server.server_close()

    # the burst: every request at once, across the two processes
    bprompts = burst_prompts(cfg)
    before = infos()
    t0 = time.perf_counter()
    refs = [handle.remote(p, max_new_tokens=SERVE_BURST_TOKENS)
            for p in bprompts]
    latency, pending = [], list(refs)
    while pending:
        ready, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                            timeout=300)
        if not ready:
            raise AssertionError("the burst stalled")
        latency.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    outs = ray_tpu_torch.get(refs)
    check_burst(outs, cfg.vocab_size)
    after = infos()
    ttfts = [x for t in after
             for x in after[t]["ttfts"][len(before[t]["ttfts"]):]]
    tps = SERVE_BURST * SERVE_BURST_TOKENS / wall
    out["burst"] = {
        "requests": SERVE_BURST, "prompt_tokens": SERVE_BURST_PROMPT,
        "new_tokens_each": SERVE_BURST_TOKENS, "wall_s": wall,
        "tokens_per_s": tps, "p50_ttft_s": float(np.median(ttfts)),
        "max_ttft_s": float(max(ttfts)),
        "p50_latency_s": float(np.median(latency)),
        "share": {t: after[t]["total_finished"] - before[t]["total_finished"]
                  for t in after},
        "chunk_period_s": {t: after[t]["chunk_period_s"] for t in after},
        "in_process": {k: in_process_burst[k] for k in (
            "tokens_per_s", "p50_ttft_s", "chunk_period_s")},
        "single_engine": in_process_burst["single_engine"]["tokens_per_s"]}
    out["seconds"] = time.perf_counter() - t_phase
    return out, mem_up


def check_cluster(torch, cfg, params, smi: str, want: list,
                  in_process_burst: dict) -> dict:
    """The cluster group: a ``Cluster`` of one node {CPU: 8, GPU: 1}, the
    driver attached with ``init(address=cluster.gcs_address)``; then
    cluster_task and cluster_serve on it. After ``serve.shutdown()`` and
    ``cluster.shutdown()`` no worker process is alive, nvidia-smi lists as
    many processes on the card as before the group (and at least
    SERVE_REPLICAS more while the replicas were up), and the card's free
    memory is back within SERVE_MEMORY_TOL of its value before the group:
    the engines stop with their processes. Returns the worker's K1
    launches and cluster_task's seconds from submission to result (a
    worker's cold start in them)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster

    t_group = time.perf_counter()
    free_card(torch)
    free_before = torch.cuda.mem_get_info()[0]
    apps_before = smi_apps()
    cluster = Cluster()
    pids = set()
    ok = False
    try:
        node = cluster.add_node(num_cpus=8, num_gpus=1,
                                store_capacity=CLUSTER_STORE_BYTES)
        ray_tpu_torch.init(address=cluster.gcs_address)
        resources = ray_tpu_torch.cluster_resources()
        k1_launches, cold_task_s = check_cluster_task(torch, ray_tpu_torch,
                                                      smi)
        # the task's lease returns its GPU before the replicas ask
        deadline = time.monotonic() + 60
        while ray_tpu_torch.available_resources().get("GPU") != 1.0:
            if time.monotonic() > deadline:
                raise AssertionError("the task's GPU never came back")
            time.sleep(0.05)
        try:
            serve_out, mem_up = check_cluster_serve(
                torch, ray_tpu_torch, cfg, params, smi, want,
                in_process_burst)
        finally:
            with node.raylet.workers.lock:
                pids |= {w.proc.pid for w in
                         node.raylet.workers.workers.values() if w.proc}
            serve.shutdown()
        ok = True
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    free_card(torch)
    time.sleep(1.0)   # the card's driver returns the processes' memory
    apps = smi_apps()
    out = {"resources": resources, "free_before": free_before,
           "free_up": mem_up, "free_after": torch.cuda.mem_get_info()[0],
           "worker_pids": sorted(pids),
           "alive_after": sorted(p for p in pids if pid_alive(p)),
           "smi_apps_before": apps_before, "smi_apps_after": apps,
           **serve_out, "seconds": time.perf_counter() - t_group}
    emit("cluster_serve", nvidia_smi=smi, config="llama3_8b",
         n_layers=cfg.n_layers, replicas=SERVE_REPLICAS,
         gpu_per_replica=1 / SERVE_REPLICAS,
         **{k: v for k, v in out.items() if k != "seconds"},
         group_seconds=out["seconds"])
    reps = out["replica_processes"]
    rep_pids = {r["pid"] for r in reps.values()}
    if not ok or len(reps) != SERVE_REPLICAS or len(rep_pids) != \
            SERVE_REPLICAS or os.getpid() in rep_pids:
        raise AssertionError(f"replica processes {reps}")
    if not all(r["checksums_equal"] and not r["jax"] and not r["ray_tpu"]
               and not r["cloudpickle"] for r in reps.values()):
        raise AssertionError(f"replica weights or modules: {reps}")
    s = out["sequential"]
    if not s["tokens_equal"] or s["control_tokens_equal"] or \
            not out["http"]["tokens_equal"]:
        raise AssertionError(f"tokens through Serve on the cluster: {s}, "
                             f"http {out['http']}")
    if sum(out["burst"]["share"].values()) != SERVE_BURST:
        raise AssertionError(f"burst shares {out['burst']['share']}")
    if len(out["smi_apps_up"]) < len(apps_before) + SERVE_REPLICAS:
        raise AssertionError(f"nvidia-smi did not list the replicas: "
                             f"{apps_before} before the group, "
                             f"{out['smi_apps_up']} while up")
    if out["alive_after"] or len(apps) != len(apps_before):
        raise AssertionError(f"worker processes left: alive "
                             f"{out['alive_after']}, on nvidia-smi {apps} "
                             f"against {apps_before} before the group")
    if abs(out["free_after"] - free_before) > SERVE_MEMORY_TOL:
        raise AssertionError(f"the card had {free_before} bytes free "
                             f"before the group and {out['free_after']} "
                             "after")
    return k1_launches, cold_task_s


# ---------------------------------------------------------------------------
# the CLI's cluster (slice 19): a node started by the port's CLI, K1 in a
# worker forked from the prestart template, a JSON config deployed by the
# CLI behind a bare ASGI ingress, and a fault-injected replica crash
# ---------------------------------------------------------------------------

# prompts over HTTP, each against check_llm_deployment's reference tokens
CLI_PROMPTS = 3
# cli_serve's engine, as cluster_serve's
CLI_SERVE_KW = {"max_batch": 8, "max_len": 2048, "page_size": 128,
                "decode_chunk": DEPLOY_NEW_TOKENS, "device": "cuda:0"}
# the deployment that cli_serve's JSON config names
CLI_TARGET = "chip_smoke:CliLLMHttp"
# the replica that the ASGI app in its process answers for
_CLI_REPLICA: list = []


def cli_prestart_task() -> dict:
    """prestart_task's task, run in a worker forked from the template: K1
    on cluster_task's seeded inputs, its output as a CUDA tensor, the
    process's report, its K1 launches and the template it came from."""
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_fwd
    from ray_tpu_torch.runtime import prestart

    zero_counts()
    q, k, v = cluster_k1_inputs(torch)
    out, _ = flash_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    return {"out": out, "launches": launch_counts(), **process_report(),
            "forked_from": (prestart.CHILD_INFO or {}).get("template_pid")}


async def cli_llm_app(scope, receive, send):
    """cli_serve's bare ASGI app (no framework), mounted by
    ``serve.ingress`` on the LLM deployment: ``POST /generate`` with a JSON
    body ``{"prompt": [...], "max_new_tokens": n}`` answers ``{"tokens":
    [...]}`` (greedy, from the replica's engine, off the app's loop);
    ``GET /info`` answers the replica's process report and the template
    it was forked from."""
    import asyncio
    import functools

    if scope["type"] == "lifespan":
        msg = await receive()
        if msg["type"] == "lifespan.startup":
            await send({"type": "lifespan.startup.complete"})
        return
    msg = await receive()
    if scope["path"] == "/info":
        from ray_tpu_torch.runtime import prestart

        payload = {**process_report(), "forked_from": (
            prestart.CHILD_INFO or {}).get("template_pid")}
    else:
        req = json.loads(msg.get("body") or b"{}")
        prompt = [int(t) for t in req["prompt"]]
        tokens = await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(_CLI_REPLICA[0].generate, prompt,
                                    int(req["max_new_tokens"])))
        payload = {"tokens": tokens}
    await send({"type": "http.response.start", "status": 200,
                "headers": [(b"content-type", b"application/json")]})
    await send({"type": "http.response.body",
                "body": json.dumps(payload).encode()})


def _cli_llm_http():
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMDeployment

    class CliLLMHttp(LLMDeployment):
        """``LLMDeployment`` that ``cli_llm_app`` answers for."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            _CLI_REPLICA[:] = [self]

        def generate(self, prompt, max_new_tokens: int) -> list:
            return LLMDeployment.__call__(self, prompt,
                                          max_new_tokens=max_new_tokens)

    CliLLMHttp.__module__ = __name__
    CliLLMHttp.__qualname__ = "CliLLMHttp"
    body = serve.ingress(cli_llm_app)(CliLLMHttp)
    return serve.deployment(body, name="LlamaHttp").bind(
        cluster_serve_model, **CLI_SERVE_KW)


def worker_processes() -> dict:
    """pid -> command line of every live (not zombie) process of the
    port's workers: cold-started workers, prestart templates and the
    workers forked from them (which keep their template's command
    line)."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rpartition(")")[2].split()[0]
        except OSError:
            continue
        if b"ray_tpu_torch.runtime.worker_main" in cmd and state != "Z":
            out[int(pid)] = b" ".join(cmd).decode(errors="replace").strip()
    return out


def maps_report(pid: int) -> dict:
    """Whether process ``pid`` maps the CUDA driver (``libcuda.so``, not
    the runtime ``libcudart``) and torch's library, from its
    ``/proc/<pid>/maps``."""
    with open(f"/proc/{pid}/maps") as f:
        libs = {ln.split()[-1].rsplit("/", 1)[-1] for ln in f
                if ".so" in ln}
    return {"libcuda_mapped": any(n.startswith("libcuda.so") for n in libs),
            "libtorch_mapped": any(n.startswith("libtorch") for n in libs)}


def http_json(url: str, body: dict | None = None, timeout: float = 600):
    """(status, JSON body) of a GET, or of a POST of ``body``."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def cli_env(**extra) -> dict:
    """This process's environment with this file's directory first on
    ``PYTHONPATH``: the CLI's processes import the port, and this file by
    the name ``chip_smoke``."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, **extra)


def cli(*args, timeout: float = 300) -> str:
    """``python -m ray_tpu_torch.scripts.cli ...`` from this file's
    directory; its standard output."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        cwd=here, env=cli_env(), capture_output=True, text=True,
        timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return out.stdout


def check_cli_prestart(torch, ray_tpu_torch, raylet, cold_task_s) -> dict:
    """prestart_task: the node's template warmed over the raylet's
    ``prestart_warm``, its own report and its ``/proc/<pid>/maps`` (no
    torch, no CUDA, no libcuda), then a ``num_gpus=1`` task in a worker
    forked from it: K1 on cluster_task's inputs bit for bit this process's
    K1 (control: non-causal), within K1's tolerance of the plain version,
    one launch, and the pool's snapshot counting the fork."""
    from ray_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain

    t0 = time.perf_counter()
    warm = raylet.call("prestart_warm", timeout_s=60.0, timeout=90)
    warm_s = time.perf_counter() - t0
    status = raylet.call("prestart_status", timeout=30).get("default", {})
    template = {"pid": warm["pid"], "ready": warm["ready"],
                "warm_s": warm_s,
                "torch_imported": status.get("torch_imported"),
                "torch_cuda_initialized": status.get("cuda_initialized"),
                "threads": status.get("threads"),
                **maps_report(warm["pid"])}
    print(f"prestart template pid {template['pid']}: "
          f"torch.cuda.is_initialized() "
          f"{template['torch_cuda_initialized']}, libcuda mapped "
          f"{template['libcuda_mapped']} (/proc/{template['pid']}/maps)",
          flush=True)
    before = raylet.call("node_info", timeout=30)["prestart"]
    k1 = ray_tpu_torch.remote(num_gpus=1)(cli_prestart_task)
    t0 = time.perf_counter()
    rep = ray_tpu_torch.get(k1.remote(), timeout=300)
    task_s = time.perf_counter() - t0
    after = raylet.call("node_info", timeout=30)["prestart"]
    q, k, v = cluster_k1_inputs(torch)
    want, _ = flash_fwd(q, k, v, causal=True)
    control, _ = flash_fwd(q, k, v, causal=False)
    plain, _ = flash_fwd_plain(q, k, v, scale=q.shape[-1] ** -0.5,
                               causal=True, with_lse=True)
    torch.cuda.synchronize()
    got = rep.pop("out")
    out = {"template": template, "task_s": task_s,
           "cold_task_s": cold_task_s, "worker": rep,
           "forked": after["forked"] - before["forked"],
           "cold_fallback": after["cold_fallback"] - before["cold_fallback"],
           "bits_equal": bool(torch.equal(got, want)),
           "control_bits_equal": bool(torch.equal(got, control)),
           # against the plain version, with check_flash's bf16 tolerances
           "max_abs_err": float((got.float() - plain.float()).abs().max()),
           "row_rel_err": row_rel_err(got, plain),
           "tol": {"max_abs_err": 8e-3, "row_rel_err": 1e-2}}
    del q, k, v, want, control, plain, got
    return out


def check_cli_cluster(torch, cfg, smi: str, want: list,
                      cold_task_s: float) -> dict:
    """The CLI's cluster: ``python -m ray_tpu_torch.scripts.cli start
    --head --num-gpus 1`` as a subprocess (the fault plane enabled for its
    processes), this process attached by ``init(address=)`` and the CLI's
    ``status`` and ``list nodes`` read; prestart_task; cli_serve:
    ``serve-deploy`` of a JSON config naming ``CliLLMHttp`` (Llama-3-8B at
    full width and depth behind ``cli_llm_app``, one replica,
    ``resources_per_replica {"GPU": 1}``), ``serve-status``, and
    CLI_PROMPTS prompts as HTTP POSTs through the proxy bit for bit
    ``check_llm_deployment``'s tokens (control: one token changed);
    fault_replica: a plan that crashes the replica at
    ``replica.mid_request`` (nth 1, max 1), the POST that hits it answered
    with the typed error, the controller's health probe replacing the
    replica (its process forked from the template), the replacement's
    tokens bit for bit. After ``serve.shutdown()`` and the node's stop no
    worker or template process is alive and the card's free memory is
    back within SERVE_MEMORY_TOL. Returns the forked worker's K1
    launches."""
    import socket
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.runtime import fault_injection as fi
    from ray_tpu_torch.runtime.rpc import RpcClient

    t_group = time.perf_counter()
    free_card(torch)
    free_before = torch.cuda.mem_get_info()[0]
    procs_before = worker_processes()
    # why the template imports no torch: on a host with a card, a fresh
    # interpreter that only imports torch maps the driver's libcuda
    probe = subprocess.Popen(
        [sys.executable, "-c", "import torch\n"
         "from ray_tpu_torch.runtime.prestart import cuda_in_process\n"
         "print(cuda_in_process())"], env=cli_env(),
        stdout=subprocess.PIPE, text=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    address = f"127.0.0.1:{port}"
    here = os.path.dirname(os.path.abspath(__file__))
    # the node's processes (raylet, workers, templates, forked workers)
    # watch the plan key; this process's plane stays off
    node_env = cli_env(RAY_TPU_FAULT_INJECTION_ENABLED="1")
    t0 = time.perf_counter()
    node = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
         "--head", "--port", str(port), "--num-cpus", "8",
         "--num-gpus", "1"], cwd=here, env=node_env,
        stdout=subprocess.PIPE, text=True)
    out = {"start_lines": [node.stdout.readline().strip()
                           for _ in range(3)]}
    out["start_s"] = time.perf_counter() - t0
    out["import_torch_alone"] = probe.communicate(timeout=120)[0].strip()
    ok = False
    raylet = None
    cfg_dir = tempfile.mkdtemp(prefix="cli_serve_")
    try:
        if not out["start_lines"][-1].startswith("connect with"):
            raise AssertionError(f"cli start: {out['start_lines']}")
        out["status"] = cli("status", "--address", address).splitlines()
        nodes = json.loads(cli("list", "nodes", "--address", address))
        out["nodes"] = [{"resources": n["resources"], "alive": n["alive"],
                         "labels": n["labels"]} for n in nodes]
        raylet = RpcClient(tuple(nodes[0]["address"]))
        ray_tpu_torch.init(address=address, namespace="serve")
        out["prestart_task"] = check_cli_prestart(
            torch, ray_tpu_torch, raylet, cold_task_s)
        free_card(torch)

        # cli_serve
        config = os.path.join(cfg_dir, "serve.json")
        with open(config, "w") as f:
            json.dump({"applications": [{"name": "cli_llm", "deployments": [
                {"import_path": CLI_TARGET, "num_replicas": 1,
                 "resources_per_replica": {"GPU": 1}}]}]}, f)
        t0 = time.perf_counter()
        deployed = cli("serve-deploy", config, "--address", address)
        server, (host, http_port) = serve.start_http_proxy()
        url = f"http://{host}:{http_port}/LlamaHttp"
        prompts, _, _ = serve_prompts(cfg)
        try:
            code, info = http_json(f"{url}/info")
            up_s = time.perf_counter() - t0
            status = json.loads(cli("serve-status", "--address", address))
            got, seconds = [], []
            for p in prompts[:CLI_PROMPTS]:
                t1 = time.perf_counter()
                code, body = http_json(f"{url}/generate", {
                    "prompt": [int(x) for x in p],
                    "max_new_tokens": DEPLOY_NEW_TOKENS})
                seconds.append(time.perf_counter() - t1)
                got.append(body.get("tokens") if code == 200 else body)
            ctl = [list(x) for x in want[:CLI_PROMPTS]]
            ctl[0][0] = (ctl[0][0] + 1) % cfg.vocab_size
            dep = status["deployments"].get("LlamaHttp", {})
            out["cli_serve"] = {
                "deployed": deployed.strip(), "up_s": up_s,
                "status": {k: dep.get(k) for k in ("target", "running")},
                "replica": info, "requests": len(got),
                "tokens_equal": got == [list(x)
                                        for x in want[:CLI_PROMPTS]],
                "control_tokens_equal": got == ctl,
                "seconds": seconds}
            mem_up = torch.cuda.mem_get_info()[0]

            # fault_replica: the plan is armed, one request straight to
            # the replica's actor hits the crash point; the plan is
            # cleared the moment the replica's process is gone, before
            # its replacement (a fresh process with fresh rule counters)
            # reads it
            before = raylet.call("node_info", timeout=30)["prestart"]
            controller = ray_tpu_torch.get_actor(serve.api.CONTROLLER_NAME)
            _, table = ray_tpu_torch.get(
                controller.get_routing_table.remote("LlamaHttp"))
            gcs = ("127.0.0.1", port)
            fi.put_plan(gcs, {"version": 1, "rules": [
                {"id": "cli-replica", "fault": "crash",
                 "point": "replica.mid_request", "proc": "worker",
                 "nth": 1, "max_hits": 1}]})
            time.sleep(1.0)   # the replica polls the plan key
            died = threading.Event()

            def heal():
                while pid_alive(info["pid"]) and not zombie(info["pid"]):
                    time.sleep(0.01)
                fi.put_plan(gcs, {"version": 2, "rules": []})
                died.set()

            healer = threading.Thread(target=heal, daemon=True)
            healer.start()
            raw = {"__raw__": True, "method": "POST", "path": "/generate",
                   "headers": [], "body": json.dumps({
                       "prompt": [int(x) for x in prompts[0]],
                       "max_new_tokens": DEPLOY_NEW_TOKENS}).encode()}
            t_crash = time.perf_counter()
            try:
                ray_tpu_torch.get(table[0]["replica"].handle_request.remote(
                    "__call__", (raw,), {}), timeout=300)
                crashed = {"error": None}
            except Exception as e:  # noqa: BLE001 - the typed error
                crashed = {"error": repr(e)[:400],
                           "type": type(e).__name__,
                           "typed": isinstance(e, ray_tpu_torch.exceptions
                                               .RayTpuError)}
            crashed["seconds"] = time.perf_counter() - t_crash
            died.wait(timeout=60)
            healer.join(timeout=60)
            # the controller's probe buries the replica and the reconciler
            # starts its replacement; its first answer bit for bit
            deadline = time.monotonic() + 300
            while True:
                code, info2 = http_json(f"{url}/info")
                if code == 200 and info2.get("pid") != info.get("pid"):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"no replacement: {code} {info2}")
                time.sleep(0.5)
            code, body = http_json(f"{url}/generate", {
                "prompt": [int(x) for x in prompts[0]],
                "max_new_tokens": DEPLOY_NEW_TOKENS})
            replace_s = time.perf_counter() - t_crash
            after = raylet.call("node_info", timeout=30)["prestart"]
            failover = ray_tpu_torch.get(
                controller.failover_stats.remote(), timeout=30)
            out["fault_replica"] = {
                "crashed": crashed, "replacement": info2,
                "replace_s": replace_s,
                "forked": after["forked"] - before["forked"],
                "tokens_equal": code == 200
                and body.get("tokens") == list(want[0]),
                "failover_events": [
                    {k: e.get(k) for k in ("deployment", "detected_at",
                                           "replaced_at")}
                    for e in failover["events"]]}
        finally:
            server.shutdown()
            server.server_close()
            serve.shutdown()
        ok = True
    finally:
        ray_tpu_torch.shutdown()
        if raylet is not None:
            raylet.close()
        node.send_signal(signal.SIGTERM)
        try:
            out["node_exit"] = node.wait(timeout=60)
        except subprocess.TimeoutExpired:
            node.kill()
            out["node_exit"] = node.wait()
        shutil.rmtree(cfg_dir, ignore_errors=True)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        left = {p: c for p, c in worker_processes().items()
                if p not in procs_before}
        if not left:
            break
        time.sleep(0.2)
    free_card(torch)
    time.sleep(1.0)   # the card's driver returns the processes' memory
    out.update({"free_before": free_before, "free_up": mem_up,
                "free_after": torch.cuda.mem_get_info()[0],
                "processes_left": left,
                "seconds": time.perf_counter() - t_group})
    emit("cli_cluster", nvidia_smi=smi, config="llama3_8b",
         n_layers=cfg.n_layers, **out)
    p = out["prestart_task"]
    t = p["template"]
    if not ok or not t["ready"] or t["torch_imported"] or \
            t["torch_cuda_initialized"] or t["libcuda_mapped"]:
        raise AssertionError(f"the prestart template: {t}")
    w = p["worker"]
    if p["forked"] < 1 or w["forked_from"] != t["pid"] or \
            w["pid"] == os.getpid() or w["jax"] or w["ray_tpu"]:
        raise AssertionError(f"the task's worker was not forked from the "
                             f"template: {p}")
    if not p["bits_equal"] or p["control_bits_equal"] or \
            p["max_abs_err"] > p["tol"]["max_abs_err"] or \
            p["row_rel_err"] > p["tol"]["row_rel_err"] or \
            w["launches"] != {"flash_fwd": 1, "flash_bwd": 0}:
        raise AssertionError(f"the forked worker's K1: {p}")
    c = out["cli_serve"]
    if c["deployed"] != "deployed LlamaHttp" or \
            c["status"] != {"target": 1, "running": 1} or \
            not c["tokens_equal"] or c["control_tokens_equal"]:
        raise AssertionError(f"cli_serve: {c}")
    f = out["fault_replica"]
    if not f["crashed"].get("typed") or \
            "crash point replica.mid_request" not in f["crashed"]["error"]:
        raise AssertionError(f"the crashed request: {f['crashed']}")
    # the replacement's process: forked from the template now, or an idle
    # worker forked earlier that the actor took over
    if f["replacement"].get("forked_from") != t["pid"] or \
            f["replacement"]["pid"] == c["replica"]["pid"] or \
            len(f["failover_events"]) != 1 or not f["tokens_equal"]:
        raise AssertionError(f"the replacement replica: {f}")
    if out["processes_left"] or out["node_exit"] != 0:
        raise AssertionError(f"processes left after the node's stop: "
                             f"{out['processes_left']}, exit "
                             f"{out['node_exit']}")
    if abs(out["free_after"] - free_before) > SERVE_MEMORY_TOL:
        raise AssertionError(f"the card had {free_before} bytes free "
                             f"before the group and {out['free_after']} "
                             "after")
    return w["launches"]


# ---------------------------------------------------------------------------
# Ray Data (slice 20): a Dataset scored by an actor pool on this card, and
# a Dataset feeding the harness's NCCL rank
# ---------------------------------------------------------------------------

# data_infer: rows of [1, 2048] tokens, one block a row, so each forward
# launches K1 at [1, 32, 8, 2048, 128] (PERF.md section 6's first row)
DATA_INFER_ROWS = 4
DATA_INFER_SEQ = 2048
# data_ingest: the stored tokens are offset by this, mod the vocabulary
DATA_OFFSET = 7
# data_ingest: repartitioned into blocks of 3 rows, so a batch of 2 rows
# is re-batched across a block boundary
DATA_INGEST_BLOCKS = 2

# the weights the actor pool's callable reads (the in-process runtime runs
# the actor in this process: nothing is pickled or copied)
_DATA_MODEL: dict = {}


def score_rows(cfg, params, tokens) -> dict:
    """llama.forward over a block's token rows [n, s] on the card; each
    row's greedy next token and its log-probability (float32)."""
    import torch

    from ray_tpu_torch.models import llama

    t = torch.from_numpy(np.ascontiguousarray(tokens)).cuda()
    with torch.no_grad():
        logp = torch.log_softmax(llama.forward(cfg, params, t)[:, -1], -1)
        nxt = logp.argmax(-1)
        best = logp.gather(-1, nxt[:, None])[:, 0]
    return {"next_token": nxt.cpu().numpy(), "logprob": best.cpu().numpy()}


class NextTokenScorer:
    """The actor pool's callable (``map_batches(NextTokenScorer,
    compute="actors")``: each actor builds one): ``score_rows`` on the
    weights in ``_DATA_MODEL``, keeping each row's index. It reads them at
    each call and holds no reference, so the weights go when the phase
    drops them, whatever becomes of the actor's instance."""

    def __call__(self, batch: dict) -> dict:
        return {"idx": batch["idx"],
                **score_rows(_DATA_MODEL["cfg"], _DATA_MODEL["params"],
                             batch["tokens"])}


def data_infer_pipeline(tokens):
    """The batch-inference pipeline over ``tokens`` [n, s]: one block a
    row, scored by a pool of one actor; its rows by index."""
    from ray_tpu_torch import data

    ds = data.from_numpy({"tokens": tokens, "idx": np.arange(len(tokens))},
                         num_blocks=len(tokens)).map_batches(
        NextTokenScorer, compute="actors", actor_pool_size=1,
        max_actor_pool_size=1)
    rows = sorted(ds.take_all(), key=lambda r: int(r["idx"]))
    return (np.array([r["next_token"] for r in rows]),
            np.array([r["logprob"] for r in rows]))


def check_data_infer(torch, cfg, params, smi: str) -> dict:
    """Ray Data batch inference on the card: DATA_INFER_ROWS seeded token
    rows of llama3_8b() (full width and depth) through
    ``ray_tpu_torch.data.from_numpy(...).map_batches(NextTokenScorer,
    compute="actors", actor_pool_size=1)`` on the in-process runtime, each
    row's greedy next token and log-probability held bit for bit against
    ``score_rows`` called directly on the same rows. Controls: the
    pipeline on a second weight seed, and on the rows with one row shifted
    by a token, must differ. K1 launches n_layers a row in the pipeline;
    the card's memory comes back within SERVE_MEMORY_TOL. Returns the
    pipeline's launches."""
    import ray_tpu_torch
    from ray_tpu_torch.models import llama

    free_card(torch)
    mem_before = torch.cuda.memory_allocated()
    rng = np.random.default_rng(SEED + 20)
    tokens = rng.integers(0, cfg.vocab_size, (DATA_INFER_ROWS,
                                              DATA_INFER_SEQ)).astype(
        np.int64)
    _DATA_MODEL.update(cfg=cfg, params=params)
    ray_tpu_torch.init()
    try:
        data_infer_pipeline(tokens[:1])     # the runtime and the actor warm
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        got_tok, got_lp = data_infer_pipeline(tokens)
        torch.cuda.synchronize()
        pipeline_s = time.perf_counter() - t0
        counts = launch_counts()
        t0 = time.perf_counter()
        direct = [score_rows(cfg, params, tokens[i:i + 1])
                  for i in range(len(tokens))]
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        want_tok = np.concatenate([d["next_token"] for d in direct])
        want_lp = np.concatenate([d["logprob"] for d in direct])
        shifted = tokens.copy()
        shifted[1] = np.roll(shifted[1], 1)
        shift_tok, shift_lp = data_infer_pipeline(shifted)
        _DATA_MODEL["params"] = llama.init_params(cfg, seed=SEED + 1,
                                                  device="cuda")
        seed_tok, seed_lp = data_infer_pipeline(tokens)
    finally:
        _DATA_MODEL.clear()
        ray_tpu_torch.shutdown()
    free_card(torch)
    mem_after = torch.cuda.memory_allocated()

    def equal(tok, lp):
        return bool(np.array_equal(tok, want_tok)
                    and np.array_equal(lp.view(np.int32),
                                       want_lp.view(np.int32)))

    out = {"rows": DATA_INFER_ROWS, "seq": DATA_INFER_SEQ,
           "bits_equal": equal(got_tok, got_lp),
           "next_tokens": got_tok.tolist(), "logprobs": got_lp.tolist(),
           "control_row_shifted_bits_equal": equal(shift_tok, shift_lp),
           "control_weight_seed_bits_equal": equal(seed_tok, seed_lp),
           "launches": counts,
           "want_launches": {"flash_fwd": cfg.n_layers * DATA_INFER_ROWS,
                             "flash_bwd": 0},
           "pipeline_s": pipeline_s, "rows_per_s":
               DATA_INFER_ROWS / pipeline_s,
           "direct_s": direct_s, "memory_before": mem_before,
           "memory_after": mem_after}
    emit("data_infer", nvidia_smi=smi, config="llama3_8b",
         n_layers=cfg.n_layers, **out)
    if not out["bits_equal"] or out["control_row_shifted_bits_equal"] or \
            out["control_weight_seed_bits_equal"]:
        raise AssertionError(f"data_infer: {out}")
    if counts != out["want_launches"]:
        raise AssertionError(f"data_infer launches {counts}, want "
                             f"{out['want_launches']}")
    if abs(mem_after - mem_before) > SERVE_MEMORY_TOL:
        raise AssertionError(f"the card held {mem_before} bytes before "
                             f"data_infer and {mem_after} after")
    return counts


def shift_tokens(batch: dict, offset: int, vocab: int) -> dict:
    """A batch's tokens shifted by ``offset``, mod ``vocab`` (module
    level: ``map_batches`` takes it bound by ``functools.partial``)."""
    return {**batch, "tokens": (batch["tokens"] + offset) % vocab}


def data_ingest_dataset(cfg, rows, undo: bool = True):
    """check_train's rows stored offset by DATA_OFFSET in a seeded order
    with their index; the pipeline undoes the offset (``map_batches``),
    restores the order (``sort`` on the index, ``drop_columns``) and
    re-blocks (``repartition``, blocks of 3 rows)."""
    import functools

    from ray_tpu_torch import data

    perm = np.random.default_rng(SEED + 21).permutation(len(rows))
    stored = {"tokens": (rows[perm] + DATA_OFFSET) % cfg.vocab_size,
              "idx": perm}
    ds = data.from_numpy(stored, num_blocks=3)
    if undo:
        ds = ds.map_batches(functools.partial(
            shift_tokens, offset=-DATA_OFFSET, vocab=cfg.vocab_size))
    return ds.sort("idx").drop_columns(["idx"]).repartition(
        DATA_INGEST_BLOCKS)


def check_data_ingest(torch, cfg, peaks, want_losses, step_counts):
    """A ``Dataset`` feeds Llama-3-8B's training step: ``TorchMeshTrainer``
    over one NCCL rank on llama3_8b() at full width and depth, 3 steps of
    [2, 2049], with ``datasets={"train": data_ingest_dataset(...)}`` (run
    once in this process, its blocks sent to the rank's queue). Held as
    harness_nccl is: the first loss bit for bit check_train's, the later
    ones within HARNESS_LOSS_TOL; the control (the pipeline without the
    undoing map, through the one-process trainer from the same seed) must
    break that bound. Returns the rank's launch counts (3 steps)."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.train.data_parallel_trainer import TorchMeshTrainer
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    b, s, steps = 2, 2048, 3
    train_cfg = TrainConfig(fused_loss=True, loss_chunk=1024, warmup_steps=1)
    rows = np.concatenate([train_batch(cfg, b, s, SEED + 4).cpu().numpy()]
                          * steps)
    ray_tpu_torch.init()
    try:
        t0 = time.perf_counter()
        blocks = [bl["tokens"] for bl in
                  data_ingest_dataset(cfg, rows).iter_batches()]
        pipeline_s = time.perf_counter() - t0
        rows_equal = bool(np.array_equal(np.concatenate(blocks), rows))
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
                datasets={"train": data_ingest_dataset(cfg, rows)}).fit()
        fit_s = time.perf_counter() - t0
        control_rows = np.concatenate([bl["tokens"] for bl in
                                       data_ingest_dataset(
                                           cfg, rows, undo=False)
                                       .iter_batches()])
    finally:
        ray_tpu_torch.shutdown()
    if result.error is not None:
        raise AssertionError(f"data_ingest failed:\n{result.error}")
    stats, = result.rank_stats
    losses = [m["loss"] for m in result.metrics_history]
    # the control, after the rank has finished: the parent trains here on
    # what the pipeline gives without its undoing map
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_cfg)
    state = trainer.init_state(seed=SEED)
    control = []
    for i in range(steps):
        batch = torch.from_numpy(control_rows[i * b:(i + 1) * b]).cuda()
        state, m = trainer.train_step(state, batch)
        control.append(float(m["loss"]))
    del state, trainer
    free_card(torch)
    control_s = time.perf_counter() - t0
    want = want_losses[:steps]

    def errs(ls):
        return ls[0] == want[0], max(abs(a - w) for a, w in
                                     zip(ls[1:], want[1:]))

    def breaks(ls):
        equal, later = errs(ls)
        return len(ls) != steps or not equal or later > HARNESS_LOSS_TOL

    timing = harness_steps(stats)
    want_counts = {k: steps * v for k, v in step_counts.items()}
    emit("data_ingest", config="llama3_8b", n_layers=cfg.n_layers,
         tokens=[b, s + 1], steps=steps, backend="nccl", world_size=1,
         device=stats["device_name"], pipeline_rows_equal=rows_equal,
         pipeline_blocks=[len(x) for x in blocks], pipeline_s=pipeline_s,
         losses=losses, check_train_losses=want,
         first_loss_bit_equal=errs(losses)[0],
         later_max_abs_err=errs(losses)[1] if len(losses) == steps
         else None, tol=HARNESS_LOSS_TOL, control_losses=control,
         control_first_loss_bit_equal=errs(control)[0],
         control_later_max_abs_err=errs(control)[1],
         data_wait_s=[st.get("data_wait") for st in timing["stages"]],
         **timing, tokens_per_s=b * s / timing["median_step_s"],
         spawn_to_first_report_s=result.first_report_s, fit_s=fit_s,
         control_s=control_s, peak_memory_bytes=stats["peak_memory_bytes"],
         launches=stats["launches"], want_launches=want_counts)
    if not rows_equal or [len(x) for x in blocks] != [3, 3]:
        raise AssertionError(f"the ingest pipeline's blocks "
                             f"{[len(x) for x in blocks]}, rows equal "
                             f"{rows_equal}")
    if breaks(losses) or not breaks(control):
        raise AssertionError(
            f"data_ingest losses {losses} against check_train's {want} "
            f"(first bit-equal, later within {HARNESS_LOSS_TOL}); the "
            f"control {control} must break that")
    if stats["launches"] != want_counts:
        raise AssertionError(f"data_ingest launches {stats['launches']}, "
                             f"want {want_counts}")
    return stats["launches"]


def check_examples(torch, smi: str) -> dict:
    """The quickstarts on this card: ``train_llama`` (llama_tiny on
    {fsdp 2, tp 2} of the card, 30 steps: losses finite and falling),
    ``llm_serving`` (its prefix-hit check, 4 streamed requests),
    ``rllib_quickstart`` (PPO on CartPole-v1, 10 iterations: stats
    finite), ``serve_quickstart`` (a deployment graph on the in-process
    runtime, called directly and over HTTP: JAX's answers) and
    ``data_pipeline`` (a Dataset's map, filter and groupby on the host:
    JAX's rows, DATA_PIPELINE_ROWS). Returns each one's kernel counts."""
    from ray_tpu_torch.examples import (data_pipeline, llm_serving,
                                        rllib_quickstart, serve_quickstart,
                                        train_llama)

    t0 = time.perf_counter()
    zero_counts()
    history = train_llama.main(device="cuda")
    train_counts = launch_counts()
    train_s = time.perf_counter() - t0
    free_card(torch)
    t0 = time.perf_counter()
    zero_counts()
    served = llm_serving.main(device="cuda")
    serve_counts = launch_counts()
    serve_s = time.perf_counter() - t0
    free_card(torch)
    t0 = time.perf_counter()
    zero_counts()
    rl_results = rllib_quickstart.main(device="cuda")
    rl_counts = launch_counts()
    rl_s = time.perf_counter() - t0
    rl_returns = [r["episode_return_mean"] for r in rl_results]
    t0 = time.perf_counter()
    zero_counts()
    graph = serve_quickstart.main()
    graph_counts = launch_counts()
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zero_counts()
    data_rows = [(int(r["group"]), r["mean(y)"])
                 for r in data_pipeline.main()]
    data_counts = launch_counts()
    data_s = time.perf_counter() - t0
    losses = [h["loss"] for h in history]
    emit("examples", nvidia_smi=smi, train_llama_losses=losses,
         train_llama_s=train_s, train_llama_launches=train_counts,
         llm_serving_prefix_hit_pages=served["prefix_cache"]["hit_pages"],
         llm_serving_tokens=[len(t) for t in served["tokens"]],
         llm_serving_s=serve_s, llm_serving_launches=serve_counts,
         rllib_quickstart_returns=rl_returns, rllib_quickstart_s=rl_s,
         rllib_quickstart_launches=rl_counts, serve_quickstart=graph,
         serve_quickstart_s=graph_s, serve_quickstart_launches=graph_counts,
         data_pipeline_rows=[[g, float(m)] for g, m in data_rows],
         data_pipeline_s=data_s, data_pipeline_launches=data_counts)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_llama losses {losses}: finite and "
                             "falling")
    if [len(t) for t in served["tokens"]] != [12] * 4:
        raise AssertionError(f"llm_serving streamed {served['tokens']}")
    if len(rl_results) != 10 or not all(
            np.isfinite(r[k]) for r in rl_results
            for k in ("policy_loss", "vf_loss", "entropy")):
        raise AssertionError(f"rllib_quickstart: {rl_results}")
    if graph != {"direct": {"sum": 12.0}, "http": {"result": {"sum": 18.0}}}:
        raise AssertionError(f"serve_quickstart answered {graph}")
    # JAX's data_pipeline example prints these rows (each group's mean of
    # y, float32)
    if [(g, type(m), float(m)) for g, m in data_rows] != [
            (g, np.float32, m) for g, m in DATA_PIPELINE_ROWS]:
        raise AssertionError(f"data_pipeline gave {data_rows}")
    return {"train_llama": train_counts, "llm_serving": serve_counts,
            "rllib_quickstart": rl_counts, "serve_quickstart": graph_counts,
            "data_pipeline": data_counts}


# ``python -m ray_tpu.examples.data_pipeline``'s rows: (group, mean(y))
DATA_PIPELINE_ROWS = ((0, 9997.0), (1, 9999.0), (2, 10001.0), (4, 9998.0),
                      (5, 10000.0), (6, 10002.0))


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
    import faulthandler

    import torch

    # a fatal signal in any thread prints every thread's stack
    faulthandler.enable(all_threads=True)
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
    # RLlib's on-policy algorithms and their learner plane (slice 12)
    rl_counts = check_rllib(torch, smi)
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
    # the serve body over the same weights (slice 13), counts zeroed in it
    deploy_counts, deploy_want, single_burst = check_llm_deployment(
        torch, cfg, params, smi)
    free_card(torch)
    # Serve on the in-process runtime (slice 17): two replicas over the
    # same weights, counts zeroed in it
    serve_run_counts, serve_run_burst = check_serve_run(
        torch, cfg, params, smi, deploy_want, single_burst)
    free_card(torch)
    # the cluster runtime (slice 18): K1 in a worker process, then two
    # replicas in their own processes, each building its own weights (this
    # process's are held for their checksums); the worker reports its
    # launches
    t0 = time.perf_counter()
    cluster_counts, cold_task_s = check_cluster(
        torch, cfg, params, smi, deploy_want, serve_run_burst)
    free_card(torch)
    emit("cluster_phases", seconds=time.perf_counter() - t0)
    # the CLI's cluster (slice 19): a node the port's CLI started, K1 in a
    # worker forked from its prestart template, a JSON config deployed by
    # the CLI behind a bare ASGI ingress, and a fault-injected replica
    # crash; the forked worker reports its launches
    t0 = time.perf_counter()
    cli_counts = check_cli_cluster(torch, cfg, smi, deploy_want,
                                   cold_task_s)
    free_card(torch)
    emit("cli_phases", seconds=time.perf_counter() - t0)
    # Ray Data (slice 20): batch inference by an actor pool of the
    # in-process runtime over these weights, counts zeroed in it
    t0 = time.perf_counter()
    data_infer_counts = check_data_infer(torch, cfg, params, smi)
    free_card(torch)
    emit("data_infer_phase", seconds=time.perf_counter() - t0)
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
    # TorchMeshTrainer on one NCCL rank (then fed by a Dataset), two gloo
    # ranks on this card at GLOO_DEPTH, and ElasticTrainer's reform at
    # ELASTIC_DEPTH while those ranks start up
    t0 = time.perf_counter()
    harness_nccl_counts = check_harness_nccl(torch, cfg, peaks, train_losses,
                                             full_counts)
    free_card(torch)
    # Ray Data (slice 20): the same rank fed by a Dataset's pipeline
    t1 = time.perf_counter()
    data_ingest_counts = check_data_ingest(torch, cfg, peaks, train_losses,
                                           full_counts)
    free_card(torch)
    emit("data_ingest_phase", seconds=time.perf_counter() - t1)
    # ElasticTrainer's reform runs here while the gloo ranks start up
    harness_gloo_counts, elastic_counts = check_harness_gloo(
        torch, cfg, peaks, meanwhile=lambda: check_elastic(torch, cfg))
    free_card(torch)
    emit("harness_phases", seconds=time.perf_counter() - t0)
    # fsdp, tp and sp across processes (slice 10), pp and ep across them
    # and the elastic reform to a new world (slice 11): one spawn of four
    # gloo ranks on this card, each phase beside its single-controller
    # counterpart, the card freed before each
    t0 = time.perf_counter()
    free_card(torch)
    world4_counts, pp_setup = check_xproc_world4(torch, cfg, peaks)
    free_card(torch)
    # the layouts whose process boundary cuts an axis, and the ring beside
    # other places in a process (slice 16): two gloo ranks the same way
    cut_counts = check_xproc_cut(torch, cfg, peaks, pp_setup)
    del pp_setup
    free_card(torch)
    emit("xproc_phases", seconds=time.perf_counter() - t0)
    # Tune (slice 13): PBT trials, each a rank process on this card, then
    # the quickstarts, each with its counts zeroed right before it
    t0 = time.perf_counter()
    tune_counts = check_tune_pbt(torch, smi)
    free_card(torch)
    example_counts = check_examples(torch, smi)
    emit("slice13_phases", seconds=time.perf_counter() - t0)
    # the other families, each at full width, one after another on the
    # card's memory (Mixtral at reduced depth)
    gpt_counts = check_gpt(torch, peaks)
    free_card(torch)
    # the tensor-parallel blocks of GPT-2 XL and BERT-large on {fsdp 2,
    # tp 2} of this card, each beside its one-card run above (Mixtral's
    # expert-parallel forward runs inside check_mixtral)
    tp_gpt_counts = check_tp_gpt(torch, peaks, gpt_counts["median_step_s"])
    bert_counts = check_bert(torch, peaks)
    tp_bert_counts = check_tp_bert(torch, bert_counts["losses"])
    vit_counts = check_vit(torch)
    mixtral_counts = check_mixtral(torch, peaks)

    by_path = {k: {"forward": launches if k == "flash_fwd" else 0,
                   "train_step_full": full_counts[k],
                   "train_step_attn": attn_counts[k],
                   "gpt2_xl_forward": gpt_counts["forward"][k],
                   "gpt2_xl_train_step_full":
                       gpt_counts["train_step_full"][k],
                   "gpt2_xl_fsdp_tp_grad_depth2": tp_gpt_counts["grad"][k],
                   "gpt2_xl_fsdp_tp_train_step_full":
                       tp_gpt_counts["train_step"][k],
                   "bert_large_train_step": bert_counts["train_step"][k],
                   "bert_large_fsdp_tp_train_step":
                       tp_bert_counts["train_step"][k],
                   "vit_l16_step": vit_counts["steps"][k],
                   "mixtral_forward": mixtral_counts["forward"][k],
                   "mixtral_grad": mixtral_counts["grad"][k],
                   "mixtral_ep_placed_forward_depth16":
                       mixtral_counts["placed_forward"][k],
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
                   "harness_gloo_dp2_rank0_3_steps": harness_gloo_counts[k],
                   "elastic_step_after_reform": elastic_counts[k],
                   "xproc_fsdp_tp_rank0_step":
                       world4_counts["xproc_fsdp_tp"][k],
                   "xproc_sp4_rank3_step": world4_counts["xproc_sp4"][k],
                   "xproc_pp_rank0_step": world4_counts["xproc_pp"][k],
                   "xproc_ep_rank0_forward":
                       world4_counts["xproc_ep"][k],
                   "xproc_elastic_rank0_step_after_reform":
                       world4_counts["xproc_elastic"][k],
                   **{f"{phase}_rank1_step": cut_counts[phase][k]
                      for phase in XPROC_CUT_TRAIN},
                   "xproc_ep4_w2_rank0_forward":
                       cut_counts["xproc_ep4_w2"][k],
                   "tune_pbt": tune_counts[k],
                   "llm_deployment": deploy_counts[k],
                   "serve_run": serve_run_counts[k],
                   "cluster_task_worker": cluster_counts[k],
                   "cli_prestart_task_forked_worker": cli_counts[k],
                   "data_infer_actor_forward": data_infer_counts[k],
                   "data_ingest_rank0_step": data_ingest_counts[k] // 3,
                   "examples_data_pipeline":
                       example_counts["data_pipeline"][k],
                   "examples_train_llama": example_counts["train_llama"][k],
                   "examples_llm_serving": example_counts["llm_serving"][k],
                   "examples_rllib_quickstart":
                       example_counts["rllib_quickstart"][k],
                   "examples_serve_quickstart":
                       example_counts["serve_quickstart"][k],
                   **{path: c[k] for path, c in rl_counts.items()}}
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
        # diagonal; d 256; a tp-2 rank of the fsdp_tp trainer (and of
        # Mixtral's placed forward); GPT-2 XL's tp-2 ranks
        **{f"{case}_shape": {k: fwd_rows[case][k] for k in (
            "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops", "max_err", "row_rel_err", "lse_err")}
           for case in ("ring_chunk_noncausal_lse", "d256_gqa2",
                        "llama3_8b_tp2", "gpt2_xl_tp2_13",
                        "gpt2_xl_tp2_12", "llama3_8b_tp4",
                        "sp2_chunk_causal_lse", "sp2_chunk_noncausal_lse",
                        "mixtral_ep4_tp2")},
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
                                  ("tp2_rank", bwd_rows["llama3_8b_tp2"]),
                                  ("gpt2_xl_tp2_13",
                                   bwd_rows["gpt2_xl_tp2_13"]),
                                  ("gpt2_xl_tp2_12",
                                   bwd_rows["gpt2_xl_tp2_12"]),
                                  ("tp4_place", bwd_rows["llama3_8b_tp4"]),
                                  ("sp2_chunk_causal",
                                   bwd_rows["sp2_chunk_causal"]),
                                  ("sp2_chunk_noncausal",
                                   bwd_rows["sp2_chunk_noncausal"]))},
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
