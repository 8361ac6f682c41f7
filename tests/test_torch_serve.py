"""The port's decoding and serving engines against ray_tpu's, on the CPU.

Weights come from JAX's ``init_params`` and carry across through
``convert.params_from_numpy``. The model runs in float32 so that the
cached forward agrees to float32 summation order (1e-4 absolute on logits
of order 1). The engines compare exact greedy tokens: the LM head is
sharpened 4x, as in tests/test_paged_serve.py, so program-level rounding
cannot flip a near-tie argmax, and requests are submitted before start()
so admission happens in one deterministic wave.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decoding as jdec
from ray_tpu.models import llama as jllama
from ray_tpu.ops import paged_attention as jpa
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.paged_llm import PagedLLMEngine as JaxPagedLLMEngine
from ray_tpu_torch import convert
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.serve.paged_llm import PagedLLMEngine


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    jparams["lm_head"] = jparams["lm_head"] * 4.0
    tparams = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def tiny_bf16():
    """The bf16 tiny model (the JAX package's own paged-vs-dense setting):
    the paged pools hold bf16 pages, so only a bf16 model's dense cache
    rounds K/V at the same points."""
    jcfg = jllama.llama_tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    jparams["lm_head"] = jparams["lm_head"] * 4.0
    tcfg = tllama.llama_tiny()
    return tcfg, convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _run(engine, prompts, max_new=16):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.start()
    outs = [list(r.tokens()) for r in reqs]
    st = engine.stats()
    engine.stop()
    assert engine.error is None
    return outs, st


PROMPT_LENS = (24, 48, 13, 70)


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(n)) for n in lens]


# --- decoding -------------------------------------------------------------


def test_cached_forward_prefill_and_decode_match_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    toks = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(
        np.int32)
    jc = jdec.init_cache(jcfg, 2, 32)
    tc = tdec.init_cache(tcfg, 2, 32, device="cpu")
    start = np.array([0, 3], np.int32)
    jl, jc = jdec.cached_forward(jcfg, jparams, jnp.asarray(toks[:, :8]), jc,
                                 start=jnp.asarray(start), logits_mode="all")
    tl, tc = tdec.cached_forward(tcfg, tparams,
                                 torch.from_numpy(toks[:, :8]).long(), tc,
                                 start=torch.from_numpy(start),
                                 logits_mode="all")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    lens = start + 8
    for i in range(8, 12):
        jl, jc = jdec.cached_forward(jcfg, jparams,
                                     jnp.asarray(toks[:, i:i + 1]), jc,
                                     start=jnp.asarray(lens))
        tl, tc = tdec.cached_forward(tcfg, tparams,
                                     torch.from_numpy(toks[:, i:i + 1]).long(),
                                     tc, start=torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        lens = lens + 1
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5)


def test_cached_forward_index_mode_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    toks = np.random.default_rng(2).integers(0, 512, (3, 16)).astype(
        np.int32)
    idx = np.array([15, 4, 9], np.int32)
    jl, _ = jdec.cached_forward(
        jcfg, jparams, jnp.asarray(toks), jdec.init_cache(jcfg, 3, 16),
        start=jnp.zeros(3, jnp.int32), logits_mode="index",
        logits_idx=jnp.asarray(idx))
    tl, _ = tdec.cached_forward(
        tcfg, tparams, torch.from_numpy(toks).long(),
        tdec.init_cache(tcfg, 3, 16, device="cpu"),
        start=torch.zeros(3, dtype=torch.int32), logits_mode="index",
        logits_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def test_write_cache_shifts_window_back_like_jax():
    """dynamic_update_slice semantics: a write that would run past the end
    moves back to fit."""
    cache = np.zeros((2, 6, 1, 1), np.float32)
    new = np.arange(1, 7, dtype=np.float32).reshape(2, 3, 1, 1)
    start = np.array([1, 5], np.int32)
    want = jdec._write_cache(jnp.asarray(cache), jnp.asarray(new),
                             jnp.asarray(start))
    got = tdec._write_cache(torch.from_numpy(cache.copy()),
                            torch.from_numpy(new), torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("eos", [None, 7])
def test_generate_greedy_matches_jax(tiny, eos):
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(3)
    prompts = np.zeros((3, 10), np.int32)
    for row, n in enumerate((10, 6, 3)):
        prompts[row, :n] = rng.integers(1, 512, n)
    sampling_j = jdec.SamplingParams(temperature=0.0, max_new_tokens=8)
    sampling_t = tdec.SamplingParams(temperature=0.0, max_new_tokens=8)
    want = jdec.generate(jcfg, jparams, jnp.asarray(prompts),
                         sampling=sampling_j, eos_id=eos)
    got = tdec.generate(tcfg, tparams, torch.from_numpy(prompts),
                        sampling=sampling_t, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_and_sample():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 0.0, 1.0, 0.5])
    toks = tdec.select_tokens(logits, temps, gen)
    assert toks.dtype == torch.int32
    assert torch.equal(toks[:2], logits[:2].argmax(-1).int())
    assert torch.equal(
        tdec.sample(logits, gen, tdec.SamplingParams(temperature=0.0)),
        logits.argmax(-1).int())
    # top_k=1 at any temperature is greedy; so is a tiny top_p
    for sp in (tdec.SamplingParams(temperature=0.7, top_k=1),
               tdec.SamplingParams(temperature=0.7, top_p=1e-6)):
        assert torch.equal(tdec.sample(logits, gen, sp),
                           logits.argmax(-1).int())
    # sampled tokens follow the softmax: a logit 20 above the rest wins
    # every draw (any other token has odds of about 2e-8 per draw)
    peaked = torch.zeros(1, 10)
    peaked[0, 3] = 20.0
    draws = [int(tdec.select_tokens(peaked, torch.tensor([1.0]), gen))
             for _ in range(50)]
    assert draws.count(3) == 50


# --- engines --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_outputs(tiny):
    """JAX's dense and paged engines on the parity prompts, run once."""
    jcfg, jparams, _, _ = tiny
    prompts = _prompts(512)
    dense, _ = _run(JaxLLMEngine(cfg=jcfg, params=jparams, max_batch=4,
                                 max_len=256), prompts)
    paged, _ = _run(JaxPagedLLMEngine(cfg=jcfg, params=jparams, max_batch=4,
                                      max_len=256, page_size=32), prompts)
    return dense, paged


def test_dense_engine_matches_jax(tiny, jax_outputs):
    _, _, tcfg, tparams = tiny
    outs, st = _run(LLMEngine(tcfg, tparams, max_batch=4, max_len=256,
                              device="cpu"), _prompts(512))
    assert outs == jax_outputs[0]
    assert st["total_finished"] == 4 and st["total_generated"] == 64
    bd = st["ttft_breakdown_s"]
    assert abs(sum(bd.values()) - st["mean_ttft_s"]) < 1e-6


def test_paged_engine_matches_jax(tiny, jax_outputs):
    _, _, tcfg, tparams = tiny
    outs, st = _run(PagedLLMEngine(tcfg, tparams, max_batch=4, max_len=256,
                                   page_size=32, device="cpu"),
                    _prompts(512))
    assert outs == jax_outputs[1]
    assert st["kv_pages_bytes"] * 2 == st["kv_dense_equiv_bytes"]
    assert st["kv_pages_total"] == 16


def test_paged_matches_dense(tiny_bf16):
    tcfg, tparams = tiny_bf16
    prompts = _prompts(512, (20, 33, 27, 5, 64), seed=7)
    dense, _ = _run(LLMEngine(tcfg, tparams, max_batch=2, max_len=128,
                              device="cpu"), prompts, max_new=12)
    paged, _ = _run(PagedLLMEngine(tcfg, tparams, max_batch=2, max_len=128,
                                   page_size=32, device="cpu"), prompts,
                    max_new=12)
    assert paged == dense


def test_paged_matches_dense_across_admission_waves(tiny_bf16):
    tcfg, tparams = tiny_bf16
    prompts = _prompts(512, (20, 33, 27), seed=8)

    def sequential(engine):
        engine.start()
        outs = [list(engine.submit(p, max_new_tokens=12).tokens())
                for p in prompts]
        engine.stop()
        return outs

    assert sequential(PagedLLMEngine(tcfg, tparams, max_batch=2,
                                     max_len=128, page_size=32,
                                     device="cpu")) == \
        sequential(LLMEngine(tcfg, tparams, max_batch=2, max_len=128,
                             device="cpu"))


def test_prefix_cache_reuse(tiny):
    _, _, tcfg, tparams = tiny
    rng = np.random.default_rng(3)
    base = rng.integers(1, 512, 96)     # 3 full pages at page_size 32
    prompts = [base, np.concatenate([base, rng.integers(1, 512, 20)]),
               np.concatenate([base, rng.integers(1, 512, 7)])]
    ref, st_ref = _run(PagedLLMEngine(tcfg, tparams, max_batch=2,
                                      max_len=256, page_size=32,
                                      prefix_cache=False, device="cpu"),
                       prompts)
    assert st_ref["prefix_cache"]["hit_pages"] == 0
    got, st = _run(PagedLLMEngine(tcfg, tparams, max_batch=2, max_len=256,
                                  page_size=32, device="cpu"), prompts)
    assert got == ref
    assert st["prefix_cache"]["hit_pages"] >= 3


def test_int8_kv_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    prompts = _prompts(512, (24, 40), seed=9)
    want, _ = _run(JaxPagedLLMEngine(cfg=jcfg, params=jparams, max_batch=2,
                                     max_len=128, page_size=32,
                                     kv_dtype="int8"), prompts, max_new=12)
    got, st = _run(PagedLLMEngine(tcfg, tparams, max_batch=2, max_len=128,
                                  page_size=32, kv_dtype="int8",
                                  device="cpu"), prompts, max_new=12)
    assert got == want
    assert st["kv_dtype"] == "int8"
    bf16 = PagedLLMEngine(tcfg, tparams, max_batch=2, max_len=128,
                          page_size=32, device="cpu")
    assert st["kv_pages_bytes"] < bf16.stats()["kv_pages_bytes"]


def test_int8_kv_with_prefix_cache(tiny):
    _, _, tcfg, tparams = tiny
    prompt = np.random.default_rng(8).integers(1, 512, 80)
    cold = PagedLLMEngine(tcfg, tparams, max_batch=1, max_len=128,
                          page_size=32, num_pages=8, kv_dtype="int8",
                          prefix_cache=False, device="cpu")
    cold.start()
    want = list(cold.submit(prompt, max_new_tokens=8).tokens())
    cold.stop()
    eng = PagedLLMEngine(tcfg, tparams, max_batch=1, max_len=128,
                         page_size=32, num_pages=8, kv_dtype="int8",
                         device="cpu")
    eng.start()
    a = list(eng.submit(prompt, max_new_tokens=8).tokens())
    b = list(eng.submit(prompt, max_new_tokens=8).tokens())
    st = eng.stats()
    eng.stop()
    assert a == want and b == want
    assert st["prefix_cache"]["hit_pages"] >= 2


def test_pool_backpressure_and_rejections(tiny):
    _, _, tcfg, tparams = tiny
    rng = np.random.default_rng(2)
    # 4 pages of 32; each request reserves ceil(44/32)+1 = 3 pages
    outs, st = _run(PagedLLMEngine(tcfg, tparams, max_batch=4, max_len=128,
                                   page_size=32, num_pages=4, device="cpu"),
                    [rng.integers(1, 512, 20) for _ in range(3)],
                    max_new=24)
    assert all(len(o) == 24 for o in outs)
    eng = PagedLLMEngine(tcfg, tparams, max_batch=2, max_len=256,
                         page_size=32, num_pages=2, device="cpu")
    eng.start()
    big = eng.submit(np.ones(100, np.int32), max_new_tokens=64)
    small = eng.submit(np.ones(8, np.int32), max_new_tokens=8)
    too_long = eng.submit(np.ones(256, np.int32), max_new_tokens=4)
    with pytest.raises(MemoryError):
        list(big.tokens())
    assert len(list(small.tokens())) == 8
    with pytest.raises(ValueError):
        list(too_long.tokens())
    eng.stop()


def test_warmup_then_serve_and_sampling(tiny):
    _, _, tcfg, tparams = tiny
    eng = PagedLLMEngine(tcfg, tparams, max_batch=2, max_len=128,
                         page_size=32, device="cpu")
    eng.warmup(20)
    eng.warmup_prefix(64, 20, max_n=2)
    eng.start()
    req = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=12,
                     temperature=0.8)
    toks = list(req.tokens())
    eng.stop()
    assert len(toks) == 12 and all(0 <= t < 512 for t in toks)
    dense = LLMEngine(tcfg, tparams, max_batch=2, max_len=64, device="cpu")
    dense.warmup(20)
    outs, _ = _run(dense, _prompts(512, (20,), seed=5), max_new=4)
    assert len(outs[0]) == 4


# --- paged helpers --------------------------------------------------------


def test_page_hashes_match_jax_bytes():
    toks = np.random.default_rng(0).integers(0, 1 << 20, 300)
    assert tpa.page_hashes(toks, 64) == jpa.page_hashes(toks, 64)
    assert len(tpa.page_hashes(toks, 64)) == 4


def test_allocator_and_prefix_cache_match_jax():
    """The same operation sequence leaves both packages' allocator and
    prefix cache in the same state."""
    state = []
    for mod in (tpa, jpa):
        alloc, cache = mod.PageAllocator(8), mod.PrefixCache()
        a = alloc.alloc(0, 3)
        b = alloc.alloc(1, 2)
        hs = mod.page_hashes(np.arange(96), 32)
        for h, p in zip(hs, a):
            cache.insert(h, p)
        got = cache.acquire(hs)
        cache.release(got)
        cache.acquire(hs[:1])
        evicted = cache.evict(5)
        alloc.free_slot(1)
        with pytest.raises(MemoryError):
            alloc.alloc(2, 100)
        state.append((a, b, got, evicted, list(alloc.free),
                      dict(alloc.owned), cache.hit_pages, cache.miss_pages,
                      cache.evictable(), alloc.pages_needed(30, 40, 32)))
    assert state[0] == state[1]


def test_quantize_kv_matches_jax():
    x = (np.random.default_rng(0).standard_normal((4, 16, 2, 64)) * 3.0
         ).astype(np.float32)
    x[0, 0] = 0.0   # zero rows: scale guard, exact zeros back
    tq, ts = tpa.quantize_kv(torch.from_numpy(x))
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(
        tpa.dequantize_kv(tq, ts).float().numpy(),
        np.asarray(jpa.dequantize_kv(jq, js), np.float32), rtol=1e-6)
    assert torch.all(tpa.dequantize_kv(tq, ts)[0, 0] == 0)


def test_paged_write_and_attention_match_jax(tiny):
    _, _, tcfg, _ = tiny
    kw = dict(num_pages=6, page_size=4, max_batch=2, max_pages_per_seq=3)
    jc = jpa.init_paged_cache(tcfg, dtype=jnp.float32, **kw)
    tc = tpa.init_paged_cache(tcfg, dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for cache, mod in ((jc, jpa), (tc, tpa)):
        alloc = mod.PageAllocator(6)
        cache.lengths[:] = 0
        mod.assign_pages(cache, alloc, 0, 6)
        mod.assign_pages(cache, alloc, 1, 9)
    nkv, hd = tcfg.n_kv_heads, tcfg.head_dim
    k1, v1 = (rng.standard_normal((6, nkv, hd)).astype(np.float32)
              for _ in range(2))
    kall, vall = (rng.standard_normal((tcfg.n_layers, 9, nkv, hd))
                  .astype(np.float32) for _ in range(2))
    # slot 0 writes 6 tokens in layer 0 (2 spill onto a hole and drop)
    jc.page_table[0, 1] = -1
    tc.page_table[0, 1] = -1
    jc = jpa.paged_write(jc, 0, 0, jnp.asarray(k1), jnp.asarray(v1), 0)
    tpa.paged_write(tc, 0, 0, torch.from_numpy(k1), torch.from_numpy(v1), 0)
    jc = jpa.paged_write_all(jc, 1, jnp.asarray(kall), jnp.asarray(vall), 0)
    tpa.paged_write_all(tc, 1, torch.from_numpy(kall),
                        torch.from_numpy(vall), 0)
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    jc.lengths[:] = tc.lengths[:] = [4, 9]
    q = rng.standard_normal((2, tcfg.n_heads, hd)).astype(np.float32)
    want = jpa.paged_attention(jnp.asarray(q), jc, 1)
    got = tpa.paged_attention(torch.from_numpy(q), tc, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    tpa.release_slot(tc, tpa.PageAllocator(6), 1)
    assert (tc.page_table[1] == -1).all() and tc.lengths[1] == 0
