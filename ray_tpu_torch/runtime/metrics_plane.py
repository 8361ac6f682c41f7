"""Cluster metrics plane: push-aggregated time series.

Port of ``ray_tpu/runtime/metrics_plane.py`` (the pusher's claim, the
pusher, the GCS store and ``summarize_histogram``). The annex registry
the pusher ships lives in ``runtime/annex.py``, the one registry of the
process. Trace spans do not ride the frames yet: the tracing plane is
not ported.

Reference analog: the opencensus stats registry in every process pushed
to a per-node metrics agent and scraped by Prometheus
(``src/ray/stats/`` + ``dashboard/modules/reporter/``). Here each
process (driver, worker, raylet, the GCS itself) periodically snapshots
its local ``ray_tpu_torch.util.metrics`` registry as a DELTA frame and
pushes it to the GCS over ``rpc_push_metrics``; the GCS keeps a ring
buffer of aggregation windows per (metric, tags) and answers
range/instant queries over ``rpc_query_metrics`` (surfaced by
``ray_tpu_torch.util.state.cluster_metrics``). Rolled windows fan out to
CH_METRICS subscribers through the same coalesced pushed-channel
machinery the actor location table uses.

Design invariant — STRICTLY BEST-EFFORT: nothing here may ever block or
slow a hot path. Instrumented call sites only touch the process-local
registry; all network IO happens on this module's dedicated pusher
thread, whose outbound buffer is bounded (oldest frames dropped on
overflow) and whose RPCs carry short timeouts. A dropped, delayed,
duplicated, or partitioned metrics frame costs observability fidelity,
never throughput.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ray_tpu_torch.runtime import annex as _annex
from ray_tpu_torch.util import metrics as _metrics

# fault-injection endpoint label for pusher connections: chaos rules
# target the metrics plane by label ("metrics") or method
# ("push_metrics") without touching co-located control RPCs
FAULT_LABEL = "metrics"

# One pusher per PROCESS: the registry is process-local, so a second
# pusher in the same process (in-process GCS under a driver, in-worker
# runtime) would double-push every series under a second src tag.
_claim_lock = threading.Lock()
_claimed: str | None = None


def claim_pusher(owner: str) -> bool:
    global _claimed
    with _claim_lock:
        if _claimed is None or _claimed == owner:
            _claimed = owner
            return True
        return False


def release_pusher(owner: str):
    global _claimed
    with _claim_lock:
        if _claimed == owner:
            _claimed = None


class MetricsPusher:
    """Per-process push loop: registry delta frames -> GCS, fire-and-
    forget. One daemon thread; hot paths never see it."""

    def __init__(self, gcs_address, src: str, *, kind: str = "worker",
                 interval_s: float | None = None):
        from ray_tpu_torch.utils.config import get_config

        cfg = get_config()
        self._addr = tuple(gcs_address)
        self._src = src
        self._kind = kind
        self._interval = (interval_s if interval_s is not None
                          else cfg.metrics_push_interval_s)
        self._buf: deque = deque()
        self._buf_cap = max(1, cfg.metrics_push_buffer)
        self._prev: dict | None = None
        self._annex_ver = -1
        self._annex_sent_t = 0.0
        self._client = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.pushed = 0
        self.dropped = 0

    def start(self) -> "MetricsPusher":
        if not _metrics.enabled() or not claim_pusher(self._src):
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-pusher")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        release_pusher(self._src)
        self._drop_client()

    # -- push machinery ------------------------------------------------

    def _ensure_client(self):
        if self._client is None:
            from ray_tpu_torch.runtime.rpc import RpcClient

            # short dial/read timeout: a partitioned GCS costs this
            # thread at most one timeout per tick, and nothing else
            self._client = RpcClient(self._addr, timeout=2.0,
                                     label=FAULT_LABEL)
        return self._client

    def _drop_client(self):
        client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except OSError:
                pass

    def flush_now(self):
        """One synchronous frame+push round (tests / teardown — same
        path the loop takes)."""
        self._tick()

    def _tick(self):
        frame, self._prev = _metrics.snapshot_delta(self._prev)
        if frame:
            if len(self._buf) >= self._buf_cap:
                self._buf.popleft()      # bounded: oldest frame drops
                self.dropped += 1
            self._buf.append((time.time(), frame))
        # annexes ride the first push of the tick; when nothing else is
        # queued but the annex set changed (or needs a freshness
        # re-stamp so GCS-side max_age filters don't expire a live
        # publisher), an empty frame carries them
        annex_ver, annex = _annex.annex_snapshot()
        now = time.time()
        want_annex = bool(annex) and (
            annex_ver != self._annex_ver
            or now - self._annex_sent_t >= max(1.0, 2 * self._interval))
        if want_annex and not self._buf:
            self._buf.append((now, {}))
        while self._buf and not self._stop.is_set():
            ts, fr = self._buf[0]
            try:
                self._ensure_client().call(
                    "push_metrics", src=self._src, kind=self._kind,
                    ts=ts, frame=fr, timeout=2.0,
                    annex=(annex if want_annex else None))
            except Exception:  # noqa: BLE001 - best-effort: retry next tick
                self._drop_client()
                return
            self._buf.popleft()
            self.pushed += 1
            if want_annex:
                self._annex_ver = annex_ver
                self._annex_sent_t = now
                want_annex = False

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the plane must never die loudly
                pass


def _with_src(key: tuple, src: str) -> tuple:
    """Extend a series tag tuple with the pushing process's node/client
    id (sorted — tag tuples are canonical sorted item tuples)."""
    if any(k == "src" for k, _ in key):
        return key
    return tuple(sorted((*key, ("src", src))))


class MetricsStore:
    """GCS-side ring-buffer time-series store: the last N aggregation
    windows per (metric, tags+src). Ingest is additive (delta frames);
    queries merge windows in range and group by requested tag keys."""

    def __init__(self, window_s: float = 5.0, windows: int = 60,
                 on_roll=None):
        self._lock = threading.Lock()
        self._window_s = window_s
        self._ring: deque = deque(maxlen=max(1, windows))
        self._cur: dict = {}
        self._cur_start = time.time()
        self._on_roll = on_roll
        self.frames = 0
        # latest annex payload per (src, key), stamped with ingest time
        self._annex: dict = {}

    # -- ingest --------------------------------------------------------

    def ingest(self, src: str, frame: dict, ts: float | None = None):
        now = time.time()
        with self._lock:
            rolled = self._maybe_roll_locked(now)
            for name, ent in frame.items():
                slot = self._cur.get(name)
                if slot is None:
                    slot = self._cur[name] = {
                        "kind": ent["kind"],
                        "boundaries": ent.get("boundaries"),
                        "series": {}}
                series = slot["series"]
                kind = ent["kind"]
                for key, payload in ent["series"].items():
                    key = _with_src(tuple(key), src)
                    if kind == "gauge":
                        series[key] = float(payload)
                    elif kind == "counter":
                        series[key] = series.get(key, 0.0) + float(payload)
                    else:
                        series[key] = _metrics.merge_hist(
                            series.get(key), payload)
            self.frames += 1
        self._publish(rolled)

    def _publish(self, rolled):
        if rolled is not None and self._on_roll is not None:
            try:
                self._on_roll(rolled)
            except Exception:  # noqa: BLE001 - publish is best-effort
                pass

    def _maybe_roll_locked(self, now: float):
        if now - self._cur_start < self._window_s or not self._cur:
            return None
        win = {"start": self._cur_start, "end": now, "data": self._cur}
        self._ring.append(win)
        self._cur = {}
        self._cur_start = now
        return win

    def put_annexes(self, src: str, annexes: dict,
                    ts: float | None = None):
        """Latest-wins upsert of one pusher's annex set. The push
        replaces the pusher's whole set: keys it no longer publishes
        are dropped, so a retracted digest disappears on the next
        frame rather than lingering until max_age expiry."""
        now = ts if ts is not None else time.time()
        with self._lock:
            for k in [k for k in self._annex if k[0] == src]:
                if k[1] not in annexes:
                    del self._annex[k]
            for key, payload in annexes.items():
                self._annex[(src, key)] = (now, payload)

    def annexes(self, prefix: str = "",
                max_age_s: float | None = None) -> list:
        """[{src, key, ts, payload}] for keys under ``prefix``, newest
        first, dropping entries older than ``max_age_s``."""
        now = time.time()
        with self._lock:
            items = [(src, key, ts, payload)
                     for (src, key), (ts, payload) in self._annex.items()
                     if key.startswith(prefix)
                     and (max_age_s is None or now - ts <= max_age_s)]
        items.sort(key=lambda it: -it[2])
        return [{"src": src, "key": key, "ts": ts, "payload": payload}
                for src, key, ts, payload in items]

    # -- queries -------------------------------------------------------

    def names(self) -> dict:
        """{metric name: kind} over every window currently held."""
        out: dict = {}
        with self._lock:
            windows = list(self._ring) + [{"data": self._cur}]
        for win in windows:
            for name, ent in win["data"].items():
                out.setdefault(name, ent["kind"])
        return out

    def query(self, name: str, tags: dict | None = None,
              last_s: float | None = None, group_by=(),
              per_window: bool = False) -> dict:
        """Merge every window overlapping the last ``last_s`` seconds
        (all held windows when None). ``tags`` filters series by subset
        match; ``group_by`` names the tag keys results are grouped on
        (empty = one cluster-wide aggregate; ``["src"]`` = per pushing
        process). ``per_window`` returns the per-window series instead
        of one merged aggregate (range query for sparklines)."""
        now = time.time()
        cutoff = now - last_s if last_s else None
        tags = tags or {}
        group_by = tuple(group_by or ())
        with self._lock:
            # windows are TIME-based, so they must advance on queries
            # too: during a full metrics-plane partition nothing
            # ingests, and without this roll the pre-partition current
            # window would read as eternally fresh — consumers keying
            # freshness off the query horizon (the serve autoscaler's
            # degradation policy) would never see the data go stale
            rolled = self._maybe_roll_locked(now)
            windows = [dict(w) for w in self._ring]
            if self._cur:
                windows.append({"start": self._cur_start, "end": now,
                                "data": self._cur})
        self._publish(rolled)
        windows = [w for w in windows
                   if cutoff is None or w["end"] >= cutoff]
        kind = None
        boundaries = None
        for w in windows:
            ent = w["data"].get(name)
            if ent is not None:
                kind = ent["kind"]
                boundaries = ent.get("boundaries")
                break
        if kind is None:
            return {"name": name, "kind": None, "groups": [],
                    "windows": 0}

        def match(key: tuple) -> bool:
            kd = dict(key)
            return all(kd.get(k) == v for k, v in tags.items())

        def group_key(key: tuple) -> tuple:
            kd = dict(key)
            return tuple((g, kd.get(g, "")) for g in group_by)

        def merge_window(win) -> dict:
            groups: dict = {}
            ent = win["data"].get(name)
            if ent is None:
                return groups
            for key, payload in ent["series"].items():
                if not match(key):
                    continue
                g = group_key(key)
                if kind == "histogram":
                    groups[g] = _metrics.merge_hist(groups.get(g),
                                                    payload)
                else:
                    # gauges across sources sum (inflight-style
                    # gauges); per-source values come via group_by
                    groups[g] = groups.get(g, 0.0) + payload
            return groups

        out = {"name": name, "kind": kind, "boundaries": boundaries,
               "windows": len(windows),
               "from": min((w["start"] for w in windows), default=now),
               "to": max((w["end"] for w in windows), default=now)}
        if per_window:
            out["series"] = [
                {"start": w["start"], "end": w["end"],
                 "groups": [{"tags": dict(g), "value": v}
                            for g, v in merge_window(w).items()]}
                for w in windows]
            return out
        merged: dict = {}
        for w in windows:
            for g, v in merge_window(w).items():
                if kind == "histogram":
                    merged[g] = _metrics.merge_hist(merged.get(g), v)
                elif kind == "gauge":
                    merged[g] = v    # latest window wins for gauges
                else:
                    merged[g] = merged.get(g, 0.0) + v
        out["groups"] = [{"tags": dict(g), "value": v}
                         for g, v in merged.items()]
        return out


def summarize_histogram(result: dict,
                        quantiles=(0.5, 0.95, 0.99)) -> dict:
    """Client-side digest of one histogram query result (merged over
    every group): count, mean, and the requested quantiles."""
    boundaries = result.get("boundaries") or ()
    merged = None
    for g in result.get("groups", ()):
        if isinstance(g.get("value"), dict):
            merged = _metrics.merge_hist(merged, g["value"])
    if merged is None or merged["count"] <= 0:
        return {"count": 0}
    out = {"count": merged["count"],
           "mean": merged["sum"] / merged["count"]}
    for q in quantiles:
        out[f"p{int(q * 100)}"] = _metrics.quantile_from_buckets(
            boundaries, merged["buckets"], q)
    return out
