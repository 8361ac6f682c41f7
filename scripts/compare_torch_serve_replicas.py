#!/usr/bin/env python3
"""Where two in-process Serve replicas on one card lose their tokens/s.

Run from the root of the repository, on a CUDA card:

    python3 scripts/compare_torch_serve_replicas.py

Llama-3-8B at full depth with seeded random weights, the burst of
``chip_smoke.py``'s ``serve_run`` (16 prompts of 128 tokens, 32 greedy
tokens each, all at once) served four ways, one after another on the same
weights:

- ``one_engine``: one ``PagedLLMEngine``, every request submitted to it;
- ``two_engines``: two engines driven by two threads of this process,
  8 requests each (the interpreter lock shared, no Serve);
- ``serve``: ``serve.run`` of two ``LLMDeployment`` replicas, as in
  ``serve_run``, the burst through the handle;
- ``serve_no_window``: the same with ``serve_continuous_admission`` off
  (the engines' timed admission window between chunks, which waits while
  a slot is free).

Each prints one JSON line: wall s, tokens/s, p50 TTFT, the most requests
the engines held at once and each engine's chunk period (the EMA of the
time between decode-chunk syncs). The card's name and power limit come
first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ENGINE_KW = {"max_batch": 8, "max_len": 2048, "page_size": 128,
             "decode_chunk": 8}


def _line(name, engines, wall, ttfts, most):
    n = 16 * 32
    print(json.dumps({
        "case": name, "wall_s": wall, "tokens_per_s": n / wall,
        "p50_ttft_s": float(np.median(ttfts)), "in_engines_most": most,
        "chunk_period_s": [e._chunk_period for e in engines]}), flush=True)


def _engines_case(chip_smoke, cfg, params, n_engines: int, name):
    from ray_tpu_torch.serve.paged_llm import PagedLLMEngine

    prompts = chip_smoke.burst_prompts(cfg)
    engines = [PagedLLMEngine(cfg, params, device="cuda:0", **ENGINE_KW)
               for _ in range(n_engines)]
    for e in engines:
        e.start()
    per = len(prompts) // n_engines
    reqs: list = [[] for _ in engines]

    def drive(i):
        reqs[i] = [engines[i].submit(p, max_new_tokens=32)
                   for p in prompts[i * per:(i + 1) * per]]
        for r in reqs[i]:
            list(r.tokens())

    t0 = time.perf_counter()
    with chip_smoke.EngineLoad(dict(enumerate(engines))) as load:
        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(n_engines)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.perf_counter() - t0
    _line(name, engines, wall, [r.ttft for rs in reqs for r in rs],
          load.most)
    for e in engines:
        e.stop()


def _serve_case(chip_smoke, cfg, params, name, system_config):
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.runtime import core
    from ray_tpu_torch.serve.llm import LLMDeployment

    chip_smoke._SERVE_MODEL.update(cfg=cfg, params=params)
    ray_tpu_torch.init(system_config=system_config)
    try:
        handle = serve.run(serve.deployment(
            LLMDeployment, num_replicas=2,
            resources_per_replica={"GPU": 0.5}).bind(
                chip_smoke.serve_model, device="cuda:0", **ENGINE_KW))
        while len(chip_smoke.replica_engines(core)) < 2:
            time.sleep(0.05)
        engines = chip_smoke.replica_engines(core)
        n_ttft = {t: len(e.ttfts) for t, e in engines.items()}
        t0 = time.perf_counter()
        with chip_smoke.EngineLoad(engines) as load:
            outs = ray_tpu_torch.get([
                handle.remote(p, max_new_tokens=32)
                for p in chip_smoke.burst_prompts(cfg)])
        wall = time.perf_counter() - t0
        chip_smoke.check_burst(outs, cfg.vocab_size)
        _line(name, list(engines.values()), wall,
              [x for t, e in engines.items()
               for x in list(e.ttfts)[n_ttft[t]:]], load.most)
        engines = None
    finally:
        serve.shutdown()
        chip_smoke.stop_replica_engines(core)
        ray_tpu_torch.shutdown()
        chip_smoke._SERVE_MODEL.clear()


def main() -> int:
    import torch

    import chip_smoke
    from ray_tpu_torch.models import llama

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, seed=chip_smoke.SEED, device="cuda")
    # a first burst warms the card and the allocator for every case
    for n, name in ((1, "warmup"), (1, "one_engine"), (2, "two_engines")):
        _engines_case(chip_smoke, cfg, params, n, name)
        chip_smoke.free_card(torch)
    _serve_case(chip_smoke, cfg, params, "serve", None)
    chip_smoke.free_card(torch)
    _serve_case(chip_smoke, cfg, params, "serve_no_window",
                {"serve_continuous_admission": False})
    return 0


if __name__ == "__main__":
    sys.exit(main())
