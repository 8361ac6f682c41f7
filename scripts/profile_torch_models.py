#!/usr/bin/env python3
"""Where the time goes in the port's other model families on one CUDA
card: a GPT-2 XL training step and a Mixtral 8x7B forward, under
torch.profiler.

Run from the root of the repository:

    python3 scripts/profile_torch_models.py [--mixtral-layers N] [--out DIR]

Seeded random weights at the published widths, bf16.

- ``gpt2_xl_train_step``: ``gpt2_xl()`` at full depth (48 layers), the
  trainer on one repeated [8, 1025] batch under remat ``full``; the step's
  wall time split into forward + loss, backward and optimizer update
  (host clock, each phase ended by a synchronize).
- ``mixtral_forward``: ``mixtral_8x7b()`` at full width and depth
  ``--mixtral-layers`` (default 16: 32 layers do not fit the card's 80
  GB), ``forward`` over [1, 2048] tokens; the device time inside each
  part of the MoE layer (the ``moe.router``, ``moe.dispatch``,
  ``moe.experts`` and ``moe.combine`` ranges of ``ops.moe.moe_ffn``).

Each prints one JSON line: the wall time, the device-busy time, the idle
share, device time by kernel family (cuBLAS GEMMs, the flash forward,
the fused flash backward and its pre- and postprocess, everything else)
and the top kernels. Full tables go to ``DIR/profile_<phase>.txt``
(default profiles/).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from profile_torch_serve import _kernels, summarize  # noqa: E402
from profile_torch_train import by_family, phases  # noqa: E402

MOE_RANGES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")


def range_ms(prof, names) -> dict:
    """Device milliseconds of the kernels launched inside each named
    ``record_function`` range."""
    import torch

    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        if e.key in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.key] += float(getattr(e, "device_time_total",
                                        getattr(e, "cuda_time_total", 0.0)))
    return {k: round(v / 1e3, 3) for k, v in out.items()}


def profiled(fn):
    """``fn()`` once under the profiler: (profiler, wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def write_table(prof, out_dir, phase):
    with open(os.path.join(out_dir, f"profile_{phase}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mixtral-layers", type=int, default=16)
    ap.add_argument("--out", default="profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import gpt, mixtral
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)

    cfg = gpt.gpt2_xl()
    trainer = Trainer(cfg, TrainConfig(warmup_steps=1))
    state = trainer.init_state(seed=0)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1025))
                             ).cuda()
    trainer.train_step(state, batch)   # warm-up
    split = phases(trainer, state, batch)
    torch.cuda.reset_peak_memory_stats()
    prof, wall = profiled(lambda: trainer.train_step(state, batch))
    print(json.dumps({
        "phase": "gpt2_xl_train_step", "layers": cfg.n_layers,
        "tokens": [8, 1025], "remat": cfg.remat, **split,
        "device_ms_by_family": by_family(prof),
        "launches": sum(e.count for e in _kernels(prof)),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        **summarize(prof, wall)}), flush=True)
    write_table(prof, args.out, "gpt2_xl_train_step")
    del trainer, state, prof

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(mixtral.mixtral_8x7b(),
                              n_layers=args.mixtral_layers)
    params = mixtral.init_params(cfg, seed=0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048))
                              ).cuda()
    mixtral.forward(cfg, params, tokens)   # warm-up
    prof, wall = profiled(lambda: mixtral.forward(cfg, params, tokens))
    print(json.dumps({
        "phase": "mixtral_forward", "layers": cfg.n_layers,
        "tokens": [1, 2048], "device_ms_by_family": by_family(prof),
        "device_ms_by_moe_range": range_ms(prof, MOE_RANGES),
        "launches": sum(e.count for e in _kernels(prof)),
        **summarize(prof, wall)}), flush=True)
    write_table(prof, args.out, "mixtral_forward")
    return 0


if __name__ == "__main__":
    sys.exit(main())
