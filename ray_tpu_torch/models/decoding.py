"""Autoregressive decoding: KV cache, prefill/decode, sampling, generation.

Port of ``ray_tpu/models/decoding.py``. One cached forward handles
prefill (T = prompt) and decode (T = 1) with per-row write offsets. The
cache is slot-based, ``[layers, max_batch, max_len, kv_heads, head_dim]``;
a slot is one row of the batch. Where JAX returns an updated cache, the
port writes the cache tensors in place (the same memory the serving
engines keep, never a copy of the whole cache) and returns the same
object. ``jax.random`` keys become ``torch.Generator``s on the logits'
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.attention import F32_MIN
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_sin_cos


@dataclass
class KVCache:
    """Slot-based KV cache.

    k, v: [n_layers, max_batch, max_len, n_kv_heads, head_dim]
    lengths: [max_batch] int32, tokens currently cached per slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def max_batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg, max_batch: int, max_len: int, dtype=None, *,
               device="cuda") -> KVCache:
    dev = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    shape = (cfg.n_layers, max_batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros((max_batch,), dtype=torch.int32,
                                       device=dev))


def _write_cache(cache_kv, new_kv, start):
    """Write new_kv [B, T, ...] into cache_kv [B, S, ...] at per-row
    offsets start [B], in place. As ``lax.dynamic_update_slice`` does, a
    window that would run past the end is shifted back to fit
    (start clamped to [0, S - T]): decode slots that run past the end of
    a chunk rely on it."""
    b, s = cache_kv.shape[:2]
    t = new_kv.shape[1]
    start = start.long().clamp(0, s - t)
    idx = start[:, None] + torch.arange(t, device=start.device)[None, :]
    rows = torch.arange(b, device=start.device)[:, None]
    cache_kv[rows, idx] = new_kv.to(cache_kv.dtype)
    return cache_kv


def _cached_attention(q, k_cache, v_cache, start, *, scale):
    """q [B, T, nh, hd]; caches [B, S, nkv, hd]; start [B] = offset of the
    first query token. Causal over the whole cache: query i attends to
    key positions <= start + i. The query heads fold as [B, T, nkv, n_rep,
    hd] against the cache, with no repeated K/V."""
    b, t, nh, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, t, nkv, nh // nkv, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          k_cache.float()) * scale
    qpos = start.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]                 # [B,T,S]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), F32_MIN, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, t, nh, hd).to(q.dtype)


def cached_forward(cfg, params, tokens, cache: KVCache, *, start=None,
                   logits_mode: str = "last", logits_idx=None):
    """Run the transformer over ``tokens`` [B, T] through the cache.

    start [B]: write offset per row (defaults to cache.lengths). The cache
    rows are written in place; ``cache.lengths`` is NOT advanced here, the
    caller owns slot bookkeeping.

    Returns (logits, cache); logits_mode:
      "last"  -> [B, vocab] at position T-1 (decode steps)
      "index" -> [B, vocab] at per-row position logits_idx [B]
      "all"   -> [B, T, vocab]
    """
    b, t = tokens.shape
    if start is None:
        start = cache.lengths
    x = params["embedding"][tokens]
    positions = start[:, None] + torch.arange(t, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    sin, cos = rope_sin_cos(positions, cfg.head_dim, theta=cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.n_layers):
        p = llama.layer_params(params, i)
        h = rms_norm(x, p["attn_norm"], eps=cfg.rms_eps)
        q = (h @ p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
        k = (h @ p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        _write_cache(cache.k[i], k, start)
        _write_cache(cache.v[i], v, start)
        attn = _cached_attention(q, cache.k[i], cache.v[i], start,
                                 scale=scale)
        x = x + attn.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"]
        x = llama.mlp_sublayer(cfg, x, p)
    x = rms_norm(x, params["final_norm"], eps=cfg.rms_eps)
    if logits_mode == "last":
        x = x[:, -1, :]
    elif logits_mode == "index":
        x = x[torch.arange(b, device=x.device), logits_idx.long()]
    elif logits_mode != "all":
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    return llama.matmul_f32(x, llama.lm_head_weights(cfg, params)), cache


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _gumbel(shape, generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise: argmax(logits + noise) draws from the
    categorical distribution of softmax(logits)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def select_tokens(logits, temps, generator):
    """The serving engines' per-slot token choice: greedy at temp 0,
    temperature-scaled categorical otherwise. One implementation shared by
    the dense and paged engines' decode and prefill programs."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    sampled = (scaled + _gumbel(logits.shape, generator, logits.device)) \
        .argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    max_new_tokens: int = 128


def sample(logits, generator, params: SamplingParams):
    """logits [B, V] -> token ids [B]. temperature == 0 means greedy."""
    if params.temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / max(params.temperature, 1e-6)
    if params.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -params.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # keep the smallest prefix with mass >= top_p (always >= 1 token)
        cutoff_idx = (cum < params.top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return (logits + _gumbel(logits.shape, generator, logits.device)) \
        .argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Whole-batch generation (offline / eval path)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def generate(cfg, params, prompts, *, generator=None,
             sampling: SamplingParams | None = None,
             eos_id: int | None = None, pad_id: int = 0):
    """Batch generation: prompts [B, P] (right-padded with pad_id; actual
    lengths inferred), returns tokens [B, max_new_tokens] (pad_id after
    eos). Runs on the prompts' device."""
    sampling = sampling or SamplingParams()
    dev = prompts.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    b, p = prompts.shape
    # length = 1 + last non-pad POSITION (not a count): a valid interior
    # token equal to pad_id must not shorten the prompt
    positions = torch.arange(p, dtype=torch.int32, device=dev)[None, :]
    prompt_lens = torch.where(prompts != pad_id, positions + 1,
                              0).amax(dim=1).clamp(min=1).to(torch.int32)
    cache = init_cache(cfg, b, p + sampling.max_new_tokens, device=dev)
    last, cache = cached_forward(
        cfg, params, prompts, cache,
        start=torch.zeros((b,), dtype=torch.int32, device=dev),
        logits_mode="index", logits_idx=prompt_lens - 1)
    tok = sample(last, generator, sampling)
    cache.lengths = prompt_lens
    done = (tok == eos_id) if eos_id is not None else \
        torch.zeros((b,), dtype=torch.bool, device=dev)
    out = [tok]
    for _ in range(sampling.max_new_tokens - 1):
        logits, cache = cached_forward(cfg, params, tok[:, None], cache,
                                       logits_mode="last")
        tok = sample(logits, generator, sampling)
        tok = torch.where(done, pad_id, tok)
        if eos_id is not None:
            done = done | (tok == eos_id)
        cache.lengths = cache.lengths + 1
        out.append(tok)
    return torch.stack(out, dim=1)
