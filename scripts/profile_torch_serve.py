#!/usr/bin/env python3
"""Where the port's time goes on one CUDA card: the Llama-3-8B forward and
the paged serving engine, under torch.profiler.

Run from the root of the repository:

    python3 scripts/profile_torch_serve.py [--layers N] [--out DIR]

Seeded random weights at llama3_8b widths (depth ``--layers``, default
the full 32). Prints one JSON line per phase: wall time, device-busy time
summed over kernels, the device's idle share, launches per decode step,
and the top kernels by device time and top operators by host time. Full
tables go to ``DIR/profile_<phase>.txt`` (default profiles/).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernels(prof):
    """Events that ran on the card (kernels, copies), not the host
    operators that launched them (those carry the same device time), nor
    the device-side spans of ``record_function`` ranges (named as their
    host range, they cover kernels already counted)."""
    import torch

    events = prof.key_averages()
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in host]


def summarize(prof, wall_s: float, top: int = 12):
    """Device time by kernel, host time by operator, and idle share."""
    events = prof.key_averages()
    kernels = sorted(((e.key[:80], _device_us(e), e.count)
                      for e in _kernels(prof)), key=lambda t: -t[1])
    busy_us = sum(t[1] for t in kernels)
    host = sorted(((e.key, float(e.self_cpu_time_total), e.count)
                   for e in events), key=lambda t: -t[1])
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s),
        "top_device_us": [[k, round(us, 1), n] for k, us, n in
                          kernels[:top]],
        "top_host_us": [[k, round(us, 1), n] for k, us, n in host[:top]],
    }


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--out", default="profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.paged_llm import PagedLLMEngine

    os.makedirs(args.out, exist_ok=True)
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=args.layers)
    params = llama.init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048))
                              ).cuda()
    llama.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        llama.forward(cfg, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarize(prof, wall)
    print(json.dumps({"phase": "forward", "layers": cfg.n_layers, **out}),
          flush=True)
    with open(os.path.join(args.out, "profile_forward.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60))

    eng = PagedLLMEngine(cfg, params, max_batch=8, max_len=2048,
                         page_size=128, decode_chunk=16)
    eng.warmup(128)
    # one decode chunk by itself: 16 steps over 8 active slots
    b = eng.max_batch
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    lens = torch.full((b,), 128, dtype=torch.int32, device="cuda")
    table = torch.arange(b * 2, dtype=torch.int32, device="cuda").view(b, 2)
    toks = torch.zeros(b, dtype=torch.int32, device="cuda")
    temps = torch.zeros(b, device="cuda")
    eng._paged_decode_impl(table, toks, lens, active, temps, chunk=16)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._paged_decode_impl(table, toks, lens, active, temps, chunk=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarize(prof, wall)
    n_kernels = sum(e.count for e in _kernels(prof))
    print(json.dumps({"phase": "decode_chunk", "layers": cfg.n_layers,
                      "batch": b, "steps": 16, "step_ms": wall / 16 * 1e3,
                      "device_launches_per_step": n_kernels / 16, **out}),
          flush=True)
    with open(os.path.join(args.out, "profile_decode.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60))

    # the serve run of chip_smoke.py: 8 requests of 128 tokens, 32 new
    prompts = [rng.integers(1, cfg.vocab_size, 128) for _ in range(8)]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.start()
        reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
        outs = [list(r.tokens()) for r in reqs]
        wall = time.perf_counter() - t0
    eng.stop()
    out = summarize(prof, wall)
    print(json.dumps({"phase": "serve", "layers": cfg.n_layers,
                      "tokens": sum(map(len, outs)),
                      "tokens_per_s": sum(map(len, outs)) / wall,
                      "p50_ttft_s": float(np.median([r.ttft for r in reqs])),
                      "stats": eng.stats().get("ttft_breakdown_s"), **out}),
          flush=True)
    with open(os.path.join(args.out, "profile_serve.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
