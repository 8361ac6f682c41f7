"""Paged-KV continuous-batching LLM engine.

Port of ``ray_tpu/serve/paged_llm.py``. The KV cache is a pool of
fixed-size pages [L, P, page, nkv, hd] and each slot owns a page list:
device memory scales with tokens in flight, not ``max_batch * max_len``.

- Decode and prefill attend over a bucketed page window: the gather width
  is the power-of-two page count covering the longest live sequence.
- Reserve-on-admit: pages for prompt + token budget + one page of chained
  overshoot; pool exhaustion is admission backpressure. Retired slots'
  pages are freed after two chunk syncs (an in-flight chunk may still
  write them).
- ``kv_dtype="int8"`` stores pages quantized per token and head, with a
  parallel pool of float32 scales; dequantization happens on gather.
- With ``prefix_cache=True`` full prompt pages form a content-addressed
  prefix cache (chained page hashes): a request whose prompt starts with
  cached pages maps them read-only and prefills only its suffix.
- The engine publishes a digest of its prefix cache (8-byte truncations
  of the cached pages' chained hashes, and the pool's free and total
  pages) into the process's annex registry (``runtime/annex.py``) under
  its replica tag, at most every ``serve_digest_publish_interval_s`` as
  chunks are emitted and on every ``stats()``, which also sets the
  metrics plane's ``ray_tpu_serve_kv_pages`` gauge (free and total
  pages). The process's metrics pusher ships both to the GCS, so serve
  handles in any process route a prompt to the replica that holds its
  prefix (``serve/prefix_router.py``).

Out-of-range writes: JAX drops a scatter to page ``num_pages``; PyTorch
would fault on the device. The pool therefore holds one extra SINK page
(index ``num_pages``) that takes every dropped write and is never in a
page table, so never read. ``stats()`` reports the usable pool
(``num_pages`` pages). Out-of-range page-table reads are clamped and then
marked as holes, as JAX's fill mode returns a negative id for them.

Engine mechanics (queues, continuous batching, chunked + pipelined
decode) are inherited from ``LLMEngine``. ``paged_decode_logits`` and
``paged_prefill_logits`` are the engine's device programs up to the
logits, callable on their own.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.decoding import _cached_attention, select_tokens
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_attention import (PageAllocator, PrefixCache,
                                               dequantize_kv, page_hashes,
                                               quantize_kv)
from ray_tpu_torch.ops.rope import apply_rope, rope_sin_cos
from ray_tpu_torch.serve.llm import LLMEngine, _bucket, _HostCopy, _upload


def _take_page(table, col):
    """table[row, col] per row (col [B] or [B, T]); a column past the
    table's width reads as a hole (-1)."""
    width = table.shape[1]
    col = col.long()
    idx = col.clamp(max=width - 1)
    got = (torch.gather(table, 1, idx[:, None])[:, 0] if col.dim() == 1
           else torch.gather(table, 1, idx))
    return torch.where(col < width, got, -1)


def _write_gather_kv(kp, vp, ks, vs, k_new, v_new, pidx, ip, table_c,
                     quantized):
    """The write-then-gather KV protocol shared by decode and prefill:
    write k/v (+ scales in int8 mode) at (pidx, ip) in place, then gather
    the table_c page window, dequantizing if quantized."""
    pidx, ip = pidx.long(), ip.long()
    if quantized:
        kq, ksc = quantize_kv(k_new)
        vq, vsc = quantize_kv(v_new)
        kp[pidx, ip] = kq
        vp[pidx, ip] = vq
        ks[pidx, ip] = ksc
        vs[pidx, ip] = vsc
        return (dequantize_kv(kp[table_c], ks[table_c]),
                dequantize_kv(vp[table_c], vs[table_c]))
    kp[pidx, ip] = k_new.to(kp.dtype)
    vp[pidx, ip] = v_new.to(vp.dtype)
    return kp[table_c], vp[table_c]


def _paged_layers(cfg, params, pools, x, sin, cos, start, pidx, ip,
                  table_c, quantized):
    """Every transformer block over x [n, T, d] with paged KV: each layer
    writes its new K/V and attends over the gathered window."""
    k_pages, v_pages, k_scale, v_scale = pools
    n, t, _ = x.shape
    s = table_c.shape[1] * k_pages.shape[2]
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.n_layers):
        p = llama.layer_params(params, i)
        h = rms_norm(x, p["attn_norm"], eps=cfg.rms_eps)
        q = (h @ p["wq"]).reshape(n, t, cfg.n_heads, cfg.head_dim)
        k = (h @ p["wk"]).reshape(n, t, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p["wv"]).reshape(n, t, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        if pidx.dim() == 1:   # decode: one token per slot
            k, v = k[:, 0], v[:, 0]
        kg, vg = _write_gather_kv(k_pages[i], v_pages[i], k_scale[i],
                                  v_scale[i], k, v, pidx, ip, table_c,
                                  quantized)
        # stale contents of the window past each row's position (page 0
        # through clamped holes, old tokens) are hidden by the causal mask
        kg = kg.reshape(n, s, cfg.n_kv_heads, cfg.head_dim)
        vg = vg.reshape(n, s, cfg.n_kv_heads, cfg.head_dim)
        attn = _cached_attention(q, kg, vg, start, scale=scale)
        x = x + attn.reshape(n, t, -1) @ p["wo"]
        x = llama.mlp_sublayer(cfg, x, p)
    return rms_norm(x, params["final_norm"], eps=cfg.rms_eps)


def paged_decode_logits(cfg, params, pools, table, toks, pos, active, *,
                        quantized: bool):
    """One decode step over every slot: token toks [B] at position pos [B]
    through page table [B, PB]. Writes each active slot's K/V into its
    page (inactive slots and holes write the sink page) and returns
    logits [B, vocab]. ``pools`` = (k_pages, v_pages, k_scale, v_scale),
    written in place; the last page of each pool is the sink."""
    page_size = pools[0].shape[2]
    sink = pools[0].shape[1] - 1
    x = params["embedding"][toks][:, None]
    sin, cos = rope_sin_cos(pos[:, None], cfg.head_dim, theta=cfg.rope_theta)
    pidx = _take_page(table, pos // page_size)
    pidx = torch.where((pidx >= 0) & active, pidx, sink)
    x = _paged_layers(cfg, params, pools, x, sin, cos, pos, pidx,
                      pos % page_size, table.clamp(min=0).long(), quantized)
    return llama.matmul_f32(x[:, 0], llama.lm_head_weights(cfg, params))


def paged_prefill_logits(cfg, params, pools, table_rows, tokens, slens,
                         starts, *, quantized: bool):
    """Prefill ``n`` prompt suffixes (tokens [n, T], padded) at absolute
    offsets starts [n] with slens [n] real tokens each, through page table
    rows [n, W]. Suffix K/V is written first, then attention runs over the
    whole gathered window, so suffix queries see a reused prefix's KV as
    the original prompt computed it. Returns the logits [n, vocab] at each
    row's last real token."""
    page_size = pools[0].shape[2]
    sink = pools[0].shape[1] - 1
    n, t = tokens.shape
    x = params["embedding"][tokens]
    rel = torch.arange(t, dtype=torch.int32, device=tokens.device)
    positions = starts[:, None] + rel[None, :]
    sin, cos = rope_sin_cos(positions, cfg.head_dim, theta=cfg.rope_theta)
    pidx = _take_page(table_rows, positions // page_size)
    valid = rel[None, :] < slens[:, None]
    pidx = torch.where((pidx >= 0) & valid, pidx, sink)
    x = _paged_layers(cfg, params, pools, x, sin, cos, starts, pidx,
                      positions % page_size, table_rows.clamp(min=0).long(),
                      quantized)
    x = x[torch.arange(n, device=x.device), (slens - 1).long()]
    return llama.matmul_f32(x, llama.lm_head_weights(cfg, params))


class PagedLLMEngine(LLMEngine):
    """LLMEngine with a paged KV cache (see the module docstring).
    Unreferenced cached prefix pages stay resident and are evicted LRU
    only when admission needs their space."""

    def __init__(self, cfg, params, *, max_batch: int = 8,
                 max_len: int = 2048, decode_chunk: int | None = None,
                 page_size: int | None = None,
                 num_pages: int | None = None,
                 prefix_cache: bool | None = None, kv_dtype: str = "bf16",
                 device="cuda"):
        from ray_tpu_torch.utils.config import get_config

        _cfg = get_config()
        if page_size is None:
            page_size = _cfg.serve_kv_page_size
        if prefix_cache is None:
            prefix_cache = _cfg.serve_prefix_cache_enabled
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.page_size = page_size
        self.max_pages_per_seq = -(-max_len // page_size)
        # default pool: half the dense equivalent, floored so every slot
        # can hold a minimal reservation (prompt page + overshoot page)
        if num_pages is not None:
            self.num_pages = num_pages
        else:
            half_dense = max_batch * self.max_pages_per_seq // 2
            floor = max_batch * min(2, self.max_pages_per_seq)
            self.num_pages = max(half_dense, floor)
        self._prefix_enabled = prefix_cache
        super().__init__(cfg, params, max_batch=max_batch, max_len=max_len,
                         decode_chunk=decode_chunk, device=device)
        self._digest_enabled = (self._prefix_enabled
                                and _cfg.serve_prefix_routing_enabled)
        self._digest_interval = float(_cfg.serve_digest_publish_interval_s)
        self._digest_t = 0.0

    # -- device state ------------------------------------------------------

    def _setup_device_state(self):
        cfg = self.cfg
        nkv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
        # num_pages usable pages + the sink page
        shape = (cfg.n_layers, self.num_pages + 1, self.page_size, nkv,
                 cfg.head_dim)
        page_dtype = torch.int8 if self.kv_dtype == "int8" else torch.bfloat16
        dev = self.device
        self._k_pages = torch.zeros(shape, dtype=page_dtype, device=dev)
        self._v_pages = torch.zeros(shape, dtype=page_dtype, device=dev)
        # per-token-per-head dequant scales (int8 mode; tiny unused
        # stand-ins in bf16 mode, so every program has one signature)
        scale_shape = (shape[:-1] if self.kv_dtype == "int8"
                       else (cfg.n_layers, 1, 1, 1))
        self._k_scale = torch.ones(scale_shape, device=dev)
        self._v_scale = torch.ones(scale_shape, device=dev)
        self._table = np.full((self.max_batch, self.max_pages_per_seq),
                              -1, np.int32)
        self._alloc = PageAllocator(self.num_pages)
        # deferred page frees: [syncs_remaining, pages]
        self._deferred_free: list[list] = []
        # prefix cache state: shared (read-only, refcounted) pages per
        # slot, the slot's cached-prefix token count, and the full-page
        # hash chain awaiting registration after its prefill dispatch
        self._prefix = PrefixCache()
        self._shared: dict[int, list[int]] = {}
        self._prefix_len = np.zeros((self.max_batch,), np.int32)
        self._pending_hashes: dict[int, list[bytes]] = {}

    @property
    def _pools(self):
        return (self._k_pages, self._v_pages, self._k_scale, self._v_scale)

    def _window_pages(self, max_covered: int) -> int:
        """Power-of-two page count covering ``max_covered`` tokens,
        clamped to the table width."""
        need = max(1, -(-max_covered // self.page_size))
        return min(_bucket(need, minimum=1), self.max_pages_per_seq)

    # -- device programs ---------------------------------------------------

    @torch.inference_mode()
    def _paged_decode_impl(self, table, tokens, lengths, active, temps, *,
                           chunk):
        """``chunk`` decode steps over every slot through the (bucketed)
        page table [B, PB]."""
        cur, lens, toks = tokens, lengths, []
        for _ in range(chunk):
            pos = torch.where(active, lens, 0)
            logits = paged_decode_logits(
                self.cfg, self.params, self._pools, table, cur, pos, active,
                quantized=self.kv_dtype == "int8")
            cur = select_tokens(logits, temps, self._gen)
            lens = torch.where(active, lens + 1, lens)
            toks.append(cur)
        toks = torch.stack(toks)
        return toks, lens, torch.where(active, toks[-1], tokens)

    @torch.inference_mode()
    def _paged_prefill_impl(self, table_rows, tokens, slens, starts, temps):
        logits = paged_prefill_logits(
            self.cfg, self.params, self._pools, table_rows, tokens, slens,
            starts, quantized=self.kv_dtype == "int8")
        return select_tokens(logits, temps, self._gen)

    # -- engine integration ------------------------------------------------

    def _pages_bucket(self) -> int:
        """Power-of-two page count covering every live slot's RESERVED
        pages, exclusive and shared-prefix."""
        owned = [len(self._alloc.owned.get(i, ()))
                 + len(self._shared.get(i, ()))
                 for i, r in enumerate(self._active) if r is not None]
        need = max(owned) if owned else 1
        pb = 1
        while pb < need:
            pb *= 2
        return min(pb, self.max_pages_per_seq)

    def _decode_call(self, chunk: int, last_tok, dev):
        pb = self._pages_bucket()
        key = ("table", pb)
        if key not in dev:
            # the sliced table uploads only on admission/retirement (the
            # _device_inputs rebuild drops stale entries)
            dev[key] = _upload(self._table[:, :pb], self.device)
        return self._paged_decode_impl(dev[key], last_tok, dev["lens"],
                                       dev["active"], dev["temps"],
                                       chunk=chunk)

    def _reserve_slot_resources(self, req, slot: int) -> bool:
        """Reserve-on-admit: pages for prompt + token budget + one page of
        chained-dispatch overshoot; exhaustion = backpressure. Cached
        full-prefix pages are mapped read-only into the slot's table and
        only the remainder is allocated; idle cached pages are evicted LRU
        when admission needs the space."""
        plen = len(req.prompt)
        budget = min(plen + req.max_new_tokens, self.max_len)
        pages = min(-(-budget // self.page_size) + 1,
                    self.max_pages_per_seq)
        if pages > self.num_pages:
            req.error = MemoryError(
                f"request needs {pages} KV pages "
                f"(prompt {plen} + budget {req.max_new_tokens}) but the "
                f"pool holds only {self.num_pages}; raise num_pages or "
                f"lower max_new_tokens")
            return False
        hits: list[int] = []
        hashes: list[bytes] = []
        if self._prefix_enabled:
            hashes = page_hashes(np.asarray(req.prompt, np.int32),
                                 self.page_size)
            # keep at least one suffix token: the first output token is
            # sampled from the suffix prefill's logits
            hits = self._prefix.acquire(hashes[:(plen - 1) // self.page_size])
        n_fresh = pages - len(hits)
        if n_fresh > len(self._alloc.free) and self._deferred_free:
            # a new admission's prefill is ordered after every in-flight
            # chunk on the stream, and prefill + decode write each page
            # position before the causal mask exposes it: deferred frees
            # are safe to reclaim for it
            self._age_deferred_frees(drain_all=True)
        if n_fresh > len(self._alloc.free) + self._prefix.evictable():
            self._prefix.release(hits)   # nothing dispatched yet
            return False
        if n_fresh > len(self._alloc.free):
            self._alloc.free.extend(
                self._prefix.evict(n_fresh - len(self._alloc.free)))
        page_ids = self._alloc.alloc(slot, n_fresh)
        self._table[slot, :] = -1
        if hits:
            self._table[slot, :len(hits)] = hits
        self._table[slot, len(hits):pages] = page_ids
        self._shared[slot] = list(hits)
        self._prefix_len[slot] = len(hits) * self.page_size
        if self._prefix_enabled:
            self._pending_hashes[slot] = hashes
        return True

    def _pack_admit(self, req, slot: int, plen: int) -> tuple:
        """Pack only the SUFFIX past the slot's cached prefix."""
        start = int(self._prefix_len[slot])
        suffix = np.asarray(req.prompt, np.int32)[start:]
        bucket = min(_bucket(len(suffix)), self.max_len)
        padded = np.zeros((bucket,), np.int32)
        padded[:len(suffix)] = suffix
        return (req, slot, plen, padded)

    def _dispatch_prefill(self, part: list, bucket: int):
        starts = np.array([self._prefix_len[it[1]] for it in part], np.int32)
        slens = np.array([it[2] for it in part], np.int32) - starts
        wp = self._window_pages(int((starts + slens).max()))
        dev = self.device
        firsts = self._paged_prefill_impl(
            _upload(np.stack([self._table[it[1]][:wp] for it in part]), dev),
            _upload(np.stack([it[3] for it in part]), dev),
            _upload(slens, dev), _upload(starts, dev),
            _upload(np.array([it[0].temperature for it in part],
                             np.float32), dev))
        # the dispatch above makes each slot's full prompt pages valid on
        # the device: register them now (any later prefill runs after it)
        for req, slot, plen, _ in part:
            self._register_prefix(slot, plen)
        return firsts

    def _register_prefix(self, slot: int, plen: int):
        """Move this slot's freshly prefilled FULL prompt pages into the
        prefix cache; a page that becomes cached turns from exclusive to
        shared, so retirement releases a reference instead of freeing."""
        hashes = self._pending_hashes.pop(slot, [])
        if not hashes:
            return
        owned = self._alloc.owned.get(slot, [])
        shared = self._shared.setdefault(slot, [])
        for i in range(len(shared), min(len(hashes), plen // self.page_size)):
            page = int(self._table[slot, i])
            if page < 0 or not self._prefix.insert(hashes[i], page):
                # an identical concurrent prompt registered first: keep
                # our copy exclusive (freed normally at retirement)
                continue
            if page in owned:
                owned.remove(page)
            shared.append(page)
            self._prefix.ref(page)

    def _publish_digest(self, force: bool = False):
        """Drop this replica's prefix-cache digest into the process annex
        registry (throttled). Engine-thread only — ``_by_hash`` has a
        single mutator."""
        if not self._digest_enabled:
            return
        now = time.monotonic()
        if not force and now - self._digest_t < self._digest_interval:
            return
        self._digest_t = now
        from ray_tpu_torch.runtime import annex
        hashes = [int.from_bytes(h[:8], "little")
                  for h in list(self._prefix._by_hash)]
        annex.set_annex(f"serve/prefix_digest/{self.replica_tag}", {
            "tag": self.replica_tag,
            "deployment": self.deployment_name,
            "page_size": self.page_size,
            "hashes": hashes,
            "kv_free": len(self._alloc.free),
            "kv_total": self.num_pages,
        })

    def _on_slot_retired(self, slot: int):
        super()._on_slot_retired(slot)   # marks device inputs dirty
        # a chunk dispatched before this retirement was observed may still
        # write the slot's own pages: free them two chunk syncs later.
        # Shared prefix pages are released now: nothing writes them.
        pages = self._alloc.owned.pop(slot, [])
        shared = self._shared.pop(slot, [])
        self._pending_hashes.pop(slot, None)
        self._table[slot, :] = -1
        self._prefix_len[slot] = 0
        if shared:
            self._prefix.release(shared)
        if pages:
            self._deferred_free.append([2, pages])

    def _age_deferred_frees(self, drain_all: bool = False):
        still = []
        for entry in self._deferred_free:
            entry[0] -= 1
            if drain_all or entry[0] <= 0:
                self._alloc.free.extend(entry[1])
            else:
                still.append(entry)
        self._deferred_free = still

    def _emit_chunk(self, toks_np, active_idx, gens):
        super()._emit_chunk(toks_np, active_idx, gens)
        self._age_deferred_frees()   # one chunk sync elapsed
        self._publish_digest()

    def _on_idle(self):
        # nothing in flight: deferred frees cannot race anything
        if self._deferred_free:
            self._age_deferred_frees(drain_all=True)

    def _warm_prefill(self, bucket: int, wp: int, start: int, max_n: int):
        n = 1
        while n <= max_n:
            def full(shape, value, dtype=torch.int32):
                return torch.full(shape, value, dtype=dtype,
                                  device=self.device)
            firsts = self._paged_prefill_impl(
                full((n, wp), -1), full((n, bucket), 0), full((n,), 1),
                full((n,), start), full((n,), 0.0, torch.float32))
            _HostCopy(firsts).numpy()
            n *= 2

    def warmup_prefix(self, prefix_len: int, tail_len: int,
                      max_n: int | None = None):
        """Run the suffix-prefill shapes a prefix-cache hit dispatches
        (tail bucket + the window covering prefix + tail) once."""
        bucket = min(_bucket(tail_len), self.max_len)
        self._warm_prefill(bucket, self._window_pages(prefix_len + bucket),
                           prefix_len,
                           max_n if max_n is not None else self.max_batch)

    def warmup(self, prompt_len: int):
        """Run the prefill at each power-of-two group size at this bucket
        and the decode chunks at every pages-bucket a run can touch once.
        Call before start()."""
        bucket = min(_bucket(prompt_len), self.max_len)
        self._warm_prefill(bucket, self._window_pages(bucket), 0,
                           self.max_batch)
        b = self.max_batch
        zeros_i = torch.zeros((b,), dtype=torch.int32, device=self.device)
        inputs = {"lens": zeros_i,
                  "active": torch.zeros((b,), dtype=torch.bool,
                                        device=self.device),
                  "temps": torch.zeros((b,), device=self.device)}
        # powers of two plus the non-power-of-two cap _pages_bucket
        # clamps to
        buckets, pb = [], 1
        while pb < self.max_pages_per_seq:
            buckets.append(pb)
            pb *= 2
        buckets.append(self.max_pages_per_seq)
        for pb in buckets:
            table = torch.full((b, pb), -1, dtype=torch.int32,
                               device=self.device)
            for chunk in {self.decode_chunk, self._drain_chunk}:
                toks, _, _ = self._paged_decode_impl(
                    table, zeros_i, zeros_i, inputs["active"],
                    inputs["temps"], chunk=chunk)
                _HostCopy(toks).numpy()
        self._lengths[:] = 0
        self._last_tok[:] = 0

    def stats(self) -> dict:
        out = super().stats()
        out["kv_pages_total"] = self.num_pages
        out["kv_pages_free"] = len(self._alloc.free)
        # feed the metrics plane: pool occupancy rides the process's next
        # pushed delta frame
        from ray_tpu_torch.util import metrics as _m
        if _m.enabled():
            g = _m.gauge("ray_tpu_serve_kv_pages",
                         "paged-KV pool size by state",
                         tag_keys=("state", "deployment", "replica"))
            base = {"deployment": self.deployment_name,
                    "replica": self.replica_tag}
            g.set(out["kv_pages_free"], tags={"state": "free", **base})
            g.set(self.num_pages, tags={"state": "total", **base})
        self._publish_digest(force=True)
        out["prefix_cache"] = {
            "enabled": self._prefix_enabled,
            "hit_pages": self._prefix.hit_pages,
            "miss_pages": self._prefix.miss_pages,
            "cached_idle_pages": self._prefix.evictable(),
        }
        out["kv_dtype"] = self.kv_dtype
        # the usable pool: K + V pages (+ their scales in int8 mode),
        # without the sink page
        per_page = (self._k_pages[:, 0].numel()
                    * self._k_pages.element_size())
        if self.kv_dtype == "int8":
            per_page += self._k_scale[:, 0].numel() * 4
        out["kv_pages_bytes"] = int(per_page * self.num_pages * 2)
        out["kv_dense_equiv_bytes"] = int(
            self.cfg.n_layers * self.max_batch * self.max_len
            * self._k_pages.shape[3] * self._k_pages.shape[4] * 2 * 2)
        return out
