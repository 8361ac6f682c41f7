"""Quickstart: continuous-batching LLM serving on the paged-KV engine.

    python -m ray_tpu_torch.examples.llm_serving

Port of ``ray_tpu/examples/llm_serving.py``: a ``PagedLLMEngine`` with
automatic prefix caching (shared system prompts reuse their KV pages,
only tails prefill), streamed tokens, temperature sampling, and the
engine stats a Serve autoscaler would act on, on the tiny demo model.
Runs on the card; ``main(device="cpu")`` runs on the CPU. The engine is
stopped before ``main`` returns.
"""

import numpy as np

from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.paged_llm import PagedLLMEngine


def main(device="cuda") -> dict:
    """Serve four requests; returns the engine's stats and each request's
    streamed tokens (``"tokens"``). Raises if the prefix cache never
    hit twice."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, seed=0, device=device)
    eng = PagedLLMEngine(cfg=cfg, params=params, max_batch=4,
                         max_len=256, page_size=32, num_pages=24,
                         decode_chunk=8, device=device)
    eng.start()
    rng = np.random.default_rng(0)

    # a shared "system prompt" + per-request tails: once the FIRST
    # request's prefill registers the prompt pages, later requests
    # reuse them read-only and prefill only their tails (requests
    # admitted in the same wave as the first can't see its pages yet —
    # registration happens at its prefill dispatch)
    system = rng.integers(1, cfg.vocab_size, 64)

    def chat(temperature=0.0):
        return eng.submit(
            np.concatenate([system, rng.integers(1, cfg.vocab_size, 12)]),
            max_new_tokens=12, temperature=temperature)

    try:
        first = chat()
        tokens = [list(first.tokens())]
        print(f"request 0: {len(tokens[0])} tokens, "
              f"ttft={first.ttft:.3f}s (cold: registers the system prompt)")
        reqs = [chat(temperature=0.0 if i % 2 == 0 else 0.7)
                for i in range(1, 4)]
        for i, r in enumerate(reqs, start=1):
            toks = list(r.tokens())          # streaming: consume as they land
            tokens.append(toks)
            print(f"request {i}: {len(toks)} tokens, "
                  f"ttft={r.ttft:.3f}s -> {toks[:6]}...")
        st = eng.stats()
    finally:
        eng.stop()
    pc = st["prefix_cache"]
    print(f"prefix cache: {pc['hit_pages']} page hits, "
          f"{pc['cached_idle_pages']} cached idle")
    print(f"kv pages: {st['kv_pages_free']}/{st['kv_pages_total']} free "
          f"({st['kv_pages_bytes'] >> 10} KiB vs "
          f"{st['kv_dense_equiv_bytes'] >> 10} KiB dense)")
    if pc["hit_pages"] < 2:
        raise AssertionError(f"prefix cache hits {pc}: want at least 2")
    print("llm serving quickstart: OK")
    return {**st, "tokens": tokens}


if __name__ == "__main__":
    main()
