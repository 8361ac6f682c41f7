#!/usr/bin/env python3
"""Where a training step's time goes on one CUDA card: the port's trainer
on Llama-3-8B, split into its phases and profiled under torch.profiler.

Run from the root of the repository:

    python3 scripts/profile_torch_train.py [--layers N] [--out DIR]

Seeded random weights at llama3_8b widths (depth ``--layers``, default
the full 32), bf16, the fused loss with 1024-row chunks, one repeated
[2, 2049] batch. For each remat policy (``full``, then ``attn``) it
prints one JSON line: the step's wall time split into forward + loss,
backward and optimizer update (host clock, each phase ended by a
synchronize), then under the profiler the device-busy time, the idle
share, device time by kernel family (cuBLAS GEMMs, the three flash
kernels, everything else) and the top kernels. Full tables go to
``DIR/profile_train_<policy>.txt`` (default profiles/).
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

from profile_torch_serve import _device_us, _kernels, summarize  # noqa: E402

# kernel-name fragments of each family (cuBLAS/cuBLASLt GEMM kernels go by
# several names across versions)
FAMILIES = (
    ("flash_fwd (K1)", ("flash_fwd_bf16_kernel",)),
    ("flash_bwd_dq (K2)", ("flash_bwd_dq_bf16_kernel",)),
    ("flash_bwd_dkv (K3)", ("flash_bwd_dkv_bf16_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "Kernel2")),
)


def by_family(prof) -> dict:
    out = {name: 0.0 for name, _ in FAMILIES}
    out["other"] = 0.0
    for e in _kernels(prof):
        fam = next((name for name, keys in FAMILIES
                    if any(k in e.key for k in keys)), "other")
        out[fam] += _device_us(e) / 1e3
    return {k: round(v, 3) for k, v in out.items()}   # ms


def phases(trainer, state, batch):
    """One train_step, timed phase by phase (the same calls, in order)."""
    import torch

    from ray_tpu_torch.train.optim import tree_leaves

    leaves = tree_leaves(state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer._loss_fn(state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trainer.optimizer.update(leaves, list(grads), state.opt_state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    state.step += 1
    return {"forward_loss_s": t1 - t0, "backward_s": t2 - t1,
            "optimizer_s": t3 - t2, "step_s": t3 - t0}


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
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=args.layers)
    trainer = Trainer(cfg, TrainConfig(fused_loss=True, loss_chunk=1024,
                                       warmup_steps=1))
    state = trainer.init_state(seed=0)
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2049))
                             ).cuda()
    for remat in ("full", "attn"):
        trainer.model_cfg = dataclasses.replace(cfg, remat=remat)
        trainer.train_step(state, batch)   # warm-up
        split = phases(trainer, state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = summarize(prof, wall)
        print(json.dumps({
            "phase": f"train_step_{remat}", "layers": cfg.n_layers,
            "tokens": [2, 2049], **split,
            "device_ms_by_family": by_family(prof),
            "launches": sum(e.count for e in _kernels(prof)),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            **out}), flush=True)
        with open(os.path.join(args.out, f"profile_train_{remat}.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                              row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
