#!/usr/bin/env python3
"""``chip_smoke.py``'s serving and cluster groups from two checkouts, on
one card, in turns.

Run from the root of the repository, on a CUDA card, with another
checkout of the repository unpacked in a git-ignored directory (for
example the parent commit: ``mkdir -p profiles/parent && git archive
HEAD | tar -x -C profiles/parent``)::

    python3 scripts/compare_torch_chip_groups.py groups PARENT OUT_DIR
    python3 scripts/compare_torch_chip_groups.py serve PARENT OUT_DIR

``groups``: this checkout's ``serve_run``, cluster group and CLI group
(each check of theirs held as in ``chip_smoke.py``), then the parent's
cluster group and this checkout's again, each after
``check_llm_deployment`` on fresh Llama-3-8B weights, so the two cluster
groups' seconds compare within one call. ``serve``: the one-engine
``serve`` line three times a process, parent, this checkout, this
checkout, parent. Each process runs in its own checkout (its
``chip_smoke`` and its ``ray_tpu_torch``) and writes its JSON lines to
``OUT_DIR/compare_<mode>_<n>_<label>.out`` (stderr beside it); the
card's name and power limit come first in each.
"""

from __future__ import annotations

import os
import subprocess
import sys

PRELUDE = """
import sys, time, torch
sys.path.insert(0, {root!r})
import chip_smoke
from ray_tpu_torch.models import llama
"""

GROUPS = PRELUDE + """
if __name__ == "__main__":
    groups = {groups!r}.split(",")
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from ray_tpu_torch import _kernels
    _kernels.build()
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, seed=chip_smoke.SEED, device="cuda")
    torch.cuda.synchronize()
    _, want, single = chip_smoke.check_llm_deployment(torch, cfg, params,
                                                      smi)
    chip_smoke.free_card(torch)
    burst = {{"tokens_per_s": None, "p50_ttft_s": None,
              "chunk_period_s": None, "single_engine": single}}
    if "serve_run" in groups:
        _, burst = chip_smoke.check_serve_run(torch, cfg, params, smi, want,
                                              single)
        chip_smoke.free_card(torch)
    cold_task_s = 10.0
    if "cluster" in groups:
        t0 = time.perf_counter()
        _, cold_task_s = chip_smoke.check_cluster(torch, cfg, params, smi,
                                                  want, burst)
        chip_smoke.emit("cluster_phases", seconds=time.perf_counter() - t0)
    del params
    chip_smoke.free_card(torch)
    if "cli" in groups:
        t0 = time.perf_counter()
        chip_smoke.check_cli_cluster(torch, cfg, smi, want, cold_task_s)
        chip_smoke.emit("cli_phases", seconds=time.perf_counter() - t0)
"""

SERVE = PRELUDE + """
if __name__ == "__main__":
    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, seed=chip_smoke.SEED, device="cuda")
    for _ in range(3):
        chip_smoke.check_serve(torch, cfg, params)
        chip_smoke.free_card(torch)
"""


def main() -> int:
    mode, parent, out_dir = sys.argv[1:4]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    if mode == "groups":
        runs = [("change", here, GROUPS, "serve_run,cluster,cli"),
                ("parent", parent, GROUPS, "cluster"),
                ("change", here, GROUPS, "cluster")]
    elif mode == "serve":
        runs = [(label, root, SERVE, "") for label, root in (
            ("parent", parent), ("change", here), ("change", here),
            ("parent", parent))]
    else:
        raise SystemExit(f"unknown mode {mode!r}: groups or serve")
    rc = 0
    for n, (label, root, code, groups) in enumerate(runs):
        root = os.path.abspath(root)
        base = os.path.join(out_dir, f"compare_{mode}_{n}_{label}")
        with open(base + ".out", "w") as out, \
                open(base + ".err", "w") as err:
            got = subprocess.call(
                [sys.executable, "-c", code.format(root=root,
                                                   groups=groups)],
                cwd=root, env={**os.environ, "PYTHONPATH": root},
                stdout=out, stderr=err)
        print(f"{n} {label} rc {got}", flush=True)
        rc |= got
    return rc


if __name__ == "__main__":
    sys.exit(main())
