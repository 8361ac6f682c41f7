#!/usr/bin/env python3
"""Llama-3-8B's placed trainer step under fsdp_tp in several checkouts of
the port, on one CUDA card, in turns.

Run from the root of the repository, each argument the root of an
unpacked checkout (``git archive``) in the order to run them, for
example parent, change, change, parent:

    python3 scripts/compare_torch_placed_train.py PARENT CHANGE CHANGE PARENT

Each run is a fresh process inside its checkout: it builds that
checkout's kernels and calls its ``chip_smoke.check_placed_train`` for
``llama3_8b()`` at full depth under fsdp_tp on {fsdp 2, tp 2}, every
place on the card ([2, 2049], the fused loss, 3 steps from
``init_state``), then profiles one more step under torch.profiler. It
prints the run's ``placed_train`` line and a ``profile`` line (the
step's device-busy milliseconds, launches, and the 12 kernels of most
device time), each with the checkout's path. The last line gives each
checkout's median steps, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from ray_tpu_torch import _kernels
from ray_tpu_torch.models import llama
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

_kernels.build()
peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
cfg = llama.llama3_8b()
L = cfg.n_layers
cs.check_placed_train(
    torch, cfg, peaks, name="fsdp_tp", axes=cs.PLACED_AXES,
    strategy="fsdp_tp", b=2, steps=3,
    want={"flash_fwd": 2 * L * 4, "flash_bwd": L * 4}, fused_loss=True,
    loss_chunk=1024)
cs.free_card(torch)
trainer = Trainer(cfg, TrainConfig(mesh_axes=cs.PLACED_AXES,
                                   strategy="fsdp_tp", warmup_steps=1,
                                   fused_loss=True, loss_chunk=1024))
state = trainer.init_state(seed=cs.SEED)
batch = cs.train_batch(cfg, 2, 2048, cs.SEED + 13)
state, m = trainer.train_step(state, batch)
float(m["loss"])
act = [torch.profiler.ProfilerActivity.CPU,
       torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=act) as prof:
    state, m = trainer.train_step(state, batch)
    float(m["loss"])
kernels = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
busy_us = sum(e.self_device_time_total for e in kernels)
top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
print(json.dumps({"phase": "profile", "device_busy_ms": busy_us / 1e3,
                  "launches": sum(e.count for e in kernels),
                  "top": [[e.key[:90], e.count,
                           e.self_device_time_total / 1e3] for e in top]}),
      flush=True)
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    medians = {}
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith('{"phase": "placed_train"') or \
                    line.startswith('{"phase": "profile"'):
                row = json.loads(line)
                print(json.dumps({**row, "tree": tree}), flush=True)
                if row["phase"] == "placed_train":
                    medians.setdefault(tree, []).append(
                        row["median_step_s"])
    print(json.dumps({"nvidia_smi": smi, "median_step_s": medians}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
