"""Prefix-affinity replica routing for serve handles.

A copy of ``ray_tpu/serve/prefix_router.py``. Reference analog: none in
the reference repo (its router balances on queue lengths only —
``serve/_private/router.py`` PowerOfTwoChoices); the design follows
production inference routers (sticky-session / prefix-cache-aware
scheduling).

Each ``PagedLLMEngine`` replica periodically publishes a compact
PREFIX DIGEST — the chained full-page hashes currently resident in its
prefix cache (truncated to 8 bytes) plus KV-pool occupancy — as an ANNEX
in the process's registry (``runtime/annex.py``), which the process's
metrics pusher ships to the GCS. The handle pulls the digests (throttled,
``serve_digest_publish_interval_s``) via
``util.state.cluster_metric_annexes`` (the GCS store on a cluster, the
process's registry in the in-process runtime) and scores candidate replicas by
the longest run of LEADING request pages already cached there. Because
page hashes are chained (hash_i covers tokens of pages 0..i), a single
set-membership hit at rank i proves the whole prefix matches — the
score is simply the length of the leading run present in the digest.

Routing decision: highest score wins when any score > 0 (ties break on
fewer outstanding requests, then more free KV pages); all-zero scores
return ``None`` and the handle falls back to its power-of-two-choices
pick. Digests older than ``serve_digest_ttl_s`` are ignored, so a
replica that stopped publishing degrades to plain p2c rather than
routing on stale affinity. The JAX package's flight-recorder event on
each pick belongs to its tracing plane and is not ported.
"""

from __future__ import annotations

import time

from ray_tpu_torch.ops.paged_attention import page_hashes

DIGEST_PREFIX = "serve/prefix_digest/"


def digest_hashes(tokens, page_size: int) -> list[int]:
    """The 8-byte-truncated chained page hashes a replica's digest
    would hold for ``tokens`` — the router-side mirror of the engine's
    ``page_hashes`` + truncation."""
    return [int.from_bytes(h[:8], "little")
            for h in page_hashes(list(tokens), page_size)]


class PrefixRouter:
    """Holds the freshest digest per replica tag and scores candidates
    for a request's prompt tokens. All state is soft: losing it costs
    cache locality, never correctness."""

    def __init__(self, ttl_s: float | None = None):
        from ray_tpu_torch.utils.config import get_config

        self._ttl = (ttl_s if ttl_s is not None
                     else get_config().serve_digest_ttl_s)
        # tag -> {ts, page_size, hashes(set), kv_free, kv_total}
        self._digests: dict[str, dict] = {}
        # chain cache for the current pick() call only (page_size ->
        # hash list); prompts differ per request, so no cross-call reuse
        self.hits = 0
        self.fallbacks = 0

    # -- digest ingest -------------------------------------------------

    def ingest(self, annexes: list) -> None:
        """Feed annex records (``cluster_metric_annexes`` output).
        Latest-wins per replica tag; non-digest records are skipped."""
        for rec in annexes or ():
            payload = rec.get("payload") or {}
            tag = payload.get("tag")
            if not tag or "hashes" not in payload:
                continue
            cur = self._digests.get(tag)
            ts = float(rec.get("ts") or 0.0)
            if cur is not None and cur["ts"] > ts:
                continue
            self._digests[tag] = {
                "ts": ts,
                "page_size": int(payload.get("page_size") or 0),
                "hashes": set(payload["hashes"]),
                "kv_free": int(payload.get("kv_free") or 0),
                "kv_total": int(payload.get("kv_total") or 0),
            }

    def forget(self, tag: str) -> None:
        self._digests.pop(tag, None)

    def digest_count(self) -> int:
        return len(self._digests)

    # -- scoring -------------------------------------------------------

    def score(self, tokens, tag: str, now: float | None = None) -> int:
        """Number of leading full pages of ``tokens`` cached at
        ``tag`` (0 for unknown/stale digests or page-size mismatch)."""
        d = self._digests.get(tag)
        now = time.time() if now is None else now
        if d is None or not d["page_size"] or now - d["ts"] > self._ttl:
            return 0
        chain = digest_hashes(tokens, d["page_size"])
        run = 0
        for h in chain:
            if h not in d["hashes"]:
                break
            run += 1
        return run

    def pick(self, tokens, candidates: dict) -> str | None:
        """Best replica tag for ``tokens`` among ``candidates``
        ({tag: outstanding count}), or None when no candidate holds any
        matching prefix (caller falls back to p2c). The score is in
        PAGES, so one hit already amortizes a whole page of prefill."""
        if not tokens or not candidates or not self._digests:
            return None
        now = time.time()
        best_tag = None
        best = (0, 0, 0)    # (score, -outstanding, kv_free)
        chains: dict[int, list[int]] = {}   # hash once per page size
        for tag, outstanding in candidates.items():
            d = self._digests.get(tag)
            if (d is None or not d["page_size"]
                    or now - d["ts"] > self._ttl):
                continue
            chain = chains.get(d["page_size"])
            if chain is None:
                chain = chains[d["page_size"]] = digest_hashes(
                    tokens, d["page_size"])
            s = 0
            for h in chain:
                if h not in d["hashes"]:
                    break
                s += 1
            if s <= 0:
                continue
            key = (s, -int(outstanding), d["kv_free"])
            if key > best:
                best = key
                best_tag = tag
        if best_tag is None:
            self.fallbacks += 1
        else:
            self.hits += 1
        return best_tag
