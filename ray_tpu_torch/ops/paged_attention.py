"""Paged KV-cache attention for serving.

Port of ``ray_tpu/ops/paged_attention.py``: the KV cache is a pool of
fixed-size pages, each sequence owns a page table, and attention gathers
a sequence's pages into a contiguous window and masks it. The page
allocator, the prefix cache and the page hashes are host-side Python and
numpy, copied here so that the port imports nothing of the JAX package;
``page_hashes`` is the same blake2b chain, so hashes match byte for byte.

Layout:
    k_pages, v_pages: [L, n_pages, page_size, n_kv, head_dim]
    page_table:       [B, max_pages_per_seq] int32 (-1 = unused)
    lengths:          [B] int32 tokens currently cached per sequence
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import F32_MIN


@dataclass
class PagedKVCache:
    """K/V pages live on the device; the page table and lengths are host
    numpy (scheduler bookkeeping mutated per request per step)."""

    k_pages: torch.Tensor    # [L, P, page, nkv, hd]
    v_pages: torch.Tensor
    page_table: np.ndarray   # [B, max_pages] int32, -1 = hole
    lengths: np.ndarray      # [B] int32


def init_paged_cache(cfg, *, num_pages: int, page_size: int,
                     max_batch: int, max_pages_per_seq: int,
                     dtype=torch.bfloat16, device="cuda") -> PagedKVCache:
    dev = resolve_device(device)
    nkv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    shape = (cfg.n_layers, num_pages, page_size, nkv, cfg.head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=dtype, device=dev),
        page_table=np.full((max_batch, max_pages_per_seq), -1, np.int32),
        lengths=np.zeros((max_batch,), np.int32),
    )


class PageAllocator:
    """Host-side free-list of page ids."""

    def __init__(self, num_pages: int):
        self.free = list(range(num_pages - 1, -1, -1))
        self.owned: dict[int, list[int]] = {}  # seq slot -> page ids

    def alloc(self, slot: int, n: int) -> list[int]:
        if len(self.free) < n:
            raise MemoryError(
                f"paged KV cache exhausted: need {n} pages, "
                f"{len(self.free)} free")
        pages = [self.free.pop() for _ in range(n)]
        self.owned.setdefault(slot, []).extend(pages)
        return pages

    def free_slot(self, slot: int):
        for p in self.owned.pop(slot, []):
            self.free.append(p)

    def pages_needed(self, cur_len: int, new_tokens: int,
                     page_size: int) -> int:
        have = (cur_len + page_size - 1) // page_size
        need = (cur_len + new_tokens + page_size - 1) // page_size
        return need - have


def _host_positions(cache: PagedKVCache, slot, start, t):
    """(kept token indices, page ids, in-page offsets) of positions
    start .. start+t-1 of ``slot``. A position on an unassigned table hole
    (-1) is left out, never written: -1 would wrap to the last page and
    corrupt another sequence's KV. The table is host numpy, so this costs
    no device sync."""
    page_size = cache.k_pages.shape[2]
    pos = start + np.arange(t)
    page_idx = cache.page_table[slot][pos // page_size]
    keep = np.nonzero(page_idx >= 0)[0]
    return (torch.from_numpy(keep), torch.from_numpy(page_idx[keep]).long(),
            torch.from_numpy(pos[keep] % page_size).long())


def paged_write(cache: PagedKVCache, layer: int, slot, k_new, v_new,
                start) -> PagedKVCache:
    """Append k_new/v_new [T, nkv, hd] for one sequence at position
    ``start``, in place. Positions map to (page_table[slot][pos // page],
    pos % page); positions on table holes are dropped."""
    keep, page_idx, in_page = _host_positions(cache, slot, start,
                                              k_new.shape[0])
    dev = cache.k_pages.device
    keep, page_idx, in_page = keep.to(dev), page_idx.to(dev), in_page.to(dev)
    cache.k_pages[layer, page_idx, in_page] = \
        k_new[keep].to(cache.k_pages.dtype)
    cache.v_pages[layer, page_idx, in_page] = \
        v_new[keep].to(cache.v_pages.dtype)
    return cache


def paged_write_all(cache: PagedKVCache, slot, k_new, v_new,
                    start) -> PagedKVCache:
    """Append k_new/v_new [L, T, nkv, hd] for ALL layers in one indexed
    write per tensor, in place."""
    keep, page_idx, in_page = _host_positions(cache, slot, start,
                                              k_new.shape[1])
    dev = cache.k_pages.device
    keep, page_idx, in_page = keep.to(dev), page_idx.to(dev), in_page.to(dev)
    cache.k_pages[:, page_idx, in_page] = \
        k_new[:, keep].to(cache.k_pages.dtype)
    cache.v_pages[:, page_idx, in_page] = \
        v_new[:, keep].to(cache.v_pages.dtype)
    return cache


def paged_attention(q, cache: PagedKVCache, layer: int, *,
                    scale: float | None = None):
    """Decode-step attention: q [B, n_heads, hd] against each sequence's
    paged KV. Gathers each sequence's pages into a contiguous
    [max_pages * page, nkv, hd] window and masks beyond ``lengths``.
    Holes (-1) gather page 0 and are masked out. Supports GQA."""
    b, nh, hd = q.shape
    page_size, nkv = cache.k_pages.shape[2], cache.k_pages.shape[3]
    max_pages = cache.page_table.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    dev = cache.k_pages.device
    table = torch.from_numpy(np.maximum(cache.page_table, 0)).long().to(dev)
    s = max_pages * page_size
    k = cache.k_pages[layer][table].reshape(b, s, nkv, hd)
    v = cache.v_pages[layer][table].reshape(b, s, nkv, hd)
    qg = q.reshape(b, nkv, nh // nkv, hd)
    logits = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k.float()) * scale
    lengths = torch.from_numpy(cache.lengths).to(dev)
    mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), F32_MIN, device=dev))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, nh, hd).to(q.dtype)


def quantize_kv(x):
    """Per-token-per-head symmetric int8 quantization over the trailing
    head_dim axis: returns (int8 values, float32 scales with the trailing
    axis dropped)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    """Inverse of quantize_kv (scale broadcast over head_dim)."""
    return (q.float() * scale[..., None]).to(dtype)


def page_hashes(tokens: np.ndarray, page_size: int) -> list[bytes]:
    """Chained content hashes of the FULL pages of a token sequence: hash
    i covers tokens[0 : (i+1)*page_size], so equal hash means equal whole
    prefix. Partial trailing pages are never hashed."""
    out: list[bytes] = []
    h = b""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    for i in range(len(toks) // page_size):
        h = hashlib.blake2b(
            h + toks[i * page_size:(i + 1) * page_size].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


class PrefixCache:
    """Host-side prefix-page registry: chained page hash -> page id, with
    per-page refcounts and LRU eviction of unreferenced pages.

    A page is SHARED (refs > 0: mapped by a live slot, never evictable or
    written), CACHED-IDLE (refs == 0, valid KV, evictable) or gone
    (evicted: its id is back on the free list and its hash dropped)."""

    def __init__(self):
        self._by_hash: dict[bytes, int] = {}
        self._hash_of: dict[int, bytes] = {}
        self._refs: dict[int, int] = {}
        self._idle: OrderedDict[int, None] = OrderedDict()  # LRU order
        self.hit_pages = 0
        self.miss_pages = 0

    def acquire(self, hashes: list[bytes]) -> list[int]:
        """Longest contiguous run of cached pages for a hash chain; each
        returned page's refcount is bumped (caller owns one release)."""
        pages: list[int] = []
        for hsh in hashes:
            page = self._by_hash.get(hsh)
            if page is None:
                self.miss_pages += 1
                break
            pages.append(page)
            self.hit_pages += 1
            self._refs[page] = self._refs.get(page, 0) + 1
            self._idle.pop(page, None)
        return pages

    def release(self, pages: list[int]):
        """Drop one reference per page; unreferenced pages stay cached
        but become evictable (most recently released = evicted last)."""
        for page in pages:
            n = self._refs.get(page, 0) - 1
            if n > 0:
                self._refs[page] = n
            else:
                self._refs.pop(page, None)
                if page in self._hash_of:
                    self._idle[page] = None
                    self._idle.move_to_end(page)

    def ref(self, page: int):
        self._refs[page] = self._refs.get(page, 0) + 1
        self._idle.pop(page, None)

    def insert(self, hsh: bytes, page: int) -> bool:
        """Register a freshly prefilled full page. False when the hash is
        already cached (the caller keeps its copy exclusive)."""
        if hsh in self._by_hash:
            return False
        self._by_hash[hsh] = page
        self._hash_of[page] = hsh
        return True

    def evictable(self) -> int:
        return len(self._idle)

    def evict(self, n: int) -> list[int]:
        """Drop up to n least-recently-released idle pages; the returned
        ids are free for reallocation."""
        out: list[int] = []
        while self._idle and len(out) < n:
            page, _ = self._idle.popitem(last=False)
            hsh = self._hash_of.pop(page)
            self._by_hash.pop(hsh, None)
            out.append(page)
        return out


# ---------------------------------------------------------------------------
# host-side helpers for the serving engine
# ---------------------------------------------------------------------------

def assign_pages(cache: PagedKVCache, allocator: PageAllocator, slot: int,
                 new_tokens: int) -> PagedKVCache:
    """Grow ``slot``'s page table to cover new_tokens more positions.
    Raises MemoryError when the sequence would outgrow
    max_pages_per_seq."""
    page_size = cache.k_pages.shape[2]
    max_pages = cache.page_table.shape[1]
    cur = int(cache.lengths[slot])
    n_new = allocator.pages_needed(cur, new_tokens, page_size)
    if n_new == 0:
        return cache
    have = (cur + page_size - 1) // page_size
    if have + n_new > max_pages:
        raise MemoryError(
            f"sequence in slot {slot} needs {have + n_new} pages, over "
            f"max_pages_per_seq={max_pages}")
    pages = allocator.alloc(slot, n_new)
    cache.page_table[slot, have:have + n_new] = pages
    return cache


def release_slot(cache: PagedKVCache, allocator: PageAllocator,
                 slot: int) -> PagedKVCache:
    allocator.free_slot(slot)
    cache.page_table[slot, :] = -1
    cache.lengths[slot] = 0
    return cache
