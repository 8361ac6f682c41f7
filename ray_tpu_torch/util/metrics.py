"""Application metrics API (reference: ``python/ray/util/metrics.py`` over
``includes/metric.pxi``; C++ registry N11 ``src/ray/stats/``).

Port of ``ray_tpu/util/metrics.py``: the same registry, series keys,
delta frames and Prometheus text, so a frame or an export of either
package reads the same. Counter/Gauge/Histogram with tag support; the
process-local registry exports Prometheus text format
(``export_prometheus``).

The registry also feeds the CLUSTER metrics plane
(``runtime/metrics_plane.py``): each process periodically snapshots the
registry as a DELTA frame (``snapshot_delta``) and pushes it to the GCS
time-series store. Hot-path call sites guard on :func:`enabled` (one
cached boolean read) and observe through pre-resolved series handles
(:meth:`Histogram.handle`): an observation takes one lock and touches
no socket."""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict

_registry_lock = threading.Lock()
_registry: dict[str, "Metric"] = {}

# ---------------------------------------------------------------------------
# master switch — resolved once from config (RAY_TPU_METRICS_ENABLED);
# hot paths read the cached module global, never the environment
# ---------------------------------------------------------------------------

_enabled: bool | None = None


def enabled() -> bool:
    """Whether hot-path instrumentation + the push plane are on.
    Resolved from config on first call, then a plain module-global read."""
    global _enabled
    if _enabled is None:
        try:
            from ray_tpu_torch.utils.config import get_config

            _enabled = bool(get_config().metrics_enabled)
        except Exception:  # noqa: BLE001 - config import cycle during boot
            return True
    return _enabled


def set_enabled(flag: bool | None):
    """Override (tests / explicit opt-out). ``None`` re-resolves from
    config on the next :func:`enabled` call."""
    global _enabled
    _enabled = flag


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: tuple = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[name] = self

    def set_default_tags(self, tags: dict):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: dict | None) -> tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: dict = defaultdict(float)

    def inc(self, value: float = 1.0, tags: dict | None = None):
        with self._lock:
            self._values[self._key(tags)] += value

    def series(self):
        with self._lock:
            return dict(self._values)


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: dict = {}

    def set(self, value: float, tags: dict | None = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)

    def series(self):
        with self._lock:
            return dict(self._values)


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)


class _HistHandle:
    """Pre-resolved (histogram, tag-key) pair for hot paths: observe()
    skips the per-call dict merge + sorted() of :meth:`Metric._key` —
    the tag tuple is computed once at handle creation."""

    __slots__ = ("_hist", "_key_t")

    def __init__(self, hist: "Histogram", key_t: tuple):
        self._hist = hist
        self._key_t = key_t

    def observe(self, value: float):
        h = self._hist
        idx = bisect.bisect_left(h.boundaries, value)
        with h._lock:
            h._counts[self._key_t][idx] += 1
            h._sums[self._key_t] += value
            h._totals[self._key_t] += 1


class Histogram(Metric):
    def __init__(self, name, description="", boundaries=DEFAULT_BUCKETS,
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries)
        self._counts: dict = defaultdict(
            lambda: [0] * (len(self.boundaries) + 1))
        self._sums: dict = defaultdict(float)
        self._totals: dict = defaultdict(int)

    def observe(self, value: float, tags: dict | None = None):
        key = self._key(tags)
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            self._counts[key][idx] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def handle(self, tags: dict | None = None) -> _HistHandle:
        return _HistHandle(self, self._key(tags))

    def series(self):
        with self._lock:
            return {k: {"buckets": list(v), "sum": self._sums[k],
                        "count": self._totals[k]}
                    for k, v in self._counts.items()}


# ---------------------------------------------------------------------------
# get-or-create constructors (instrumented modules resolve their metric
# once at module/first-use time; re-registration must return the live
# instance, not shadow its accumulated series)
# ---------------------------------------------------------------------------


def _get_or_create(cls, name, description, **kwargs):
    with _registry_lock:
        m = _registry.get(name)
    if m is not None and type(m) is cls:
        return m
    return cls(name, description, **kwargs)


def counter(name: str, description: str = "", tag_keys=()) -> Counter:
    return _get_or_create(Counter, name, description, tag_keys=tag_keys)


def gauge(name: str, description: str = "", tag_keys=()) -> Gauge:
    return _get_or_create(Gauge, name, description, tag_keys=tag_keys)


def histogram(name: str, description: str = "",
              boundaries=DEFAULT_BUCKETS, tag_keys=()) -> Histogram:
    return _get_or_create(Histogram, name, description,
                          boundaries=boundaries, tag_keys=tag_keys)


def clear_registry():
    """Tests only: drop every registered metric (a fresh process-local
    registry; live Metric objects keep working but stop being exported)."""
    with _registry_lock:
        _registry.clear()


# ---------------------------------------------------------------------------
# snapshots + delta frames (the push plane's wire unit)
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    """Cumulative snapshot of every registered metric:
    ``{name: {"kind", "boundaries"?, "series": {tag_key_tuple: payload}}}``
    where payload is a float (counter/gauge) or
    ``{"buckets": [...], "sum": s, "count": n}`` (histogram)."""
    with _registry_lock:
        metrics = list(_registry.values())
    out = {}
    for m in metrics:
        entry = {"kind": type(m).__name__.lower(), "series": m.series()}
        if isinstance(m, Histogram):
            entry["boundaries"] = list(m.boundaries)
        out[m.name] = entry
    return out


def snapshot_delta(prev: dict | None) -> tuple[dict, dict]:
    """One push frame: counters/histograms as DELTAS against ``prev``
    (the last snapshot this process successfully framed), gauges as
    current values. Returns ``(frame, new_prev)``; empty series are
    dropped so an idle process frames nothing. A counter/bucket that
    went BACKWARDS (registry cleared) resends its current value."""
    cur = snapshot()
    prev = prev or {}
    frame: dict = {}
    for name, entry in cur.items():
        kind = entry["kind"]
        prev_series = (prev.get(name) or {}).get("series", {})
        out_series: dict = {}
        if kind == "gauge":
            out_series = dict(entry["series"])
        elif kind == "counter":
            for key, val in entry["series"].items():
                base = prev_series.get(key, 0.0)
                d = val - base if val >= base else val
                if d != 0.0:
                    out_series[key] = d
        else:  # histogram
            for key, data in entry["series"].items():
                base = prev_series.get(key)
                if base is None or base["count"] > data["count"]:
                    d = data
                else:
                    d = {"buckets": [a - b for a, b in
                                     zip(data["buckets"], base["buckets"])],
                         "sum": data["sum"] - base["sum"],
                         "count": data["count"] - base["count"]}
                if d["count"] > 0:
                    out_series[key] = d
        if out_series:
            ent = {"kind": kind, "series": out_series}
            if "boundaries" in entry:
                ent["boundaries"] = entry["boundaries"]
            frame[name] = ent
    return frame, cur


def merge_hist(into: dict | None, data: dict) -> dict:
    """Accumulate one histogram payload into another (additive across
    processes/windows — the cluster-aggregation primitive)."""
    if into is None:
        return {"buckets": list(data["buckets"]), "sum": data["sum"],
                "count": data["count"]}
    into["buckets"] = [a + b for a, b in zip(into["buckets"],
                                             data["buckets"])]
    into["sum"] += data["sum"]
    into["count"] += data["count"]
    return into


def quantile_from_buckets(boundaries, buckets, q: float) -> float | None:
    """Quantile estimate from cumulative-able bucket counts (linear
    interpolation inside the winning bucket; the +Inf bucket returns its
    lower bound — same convention as Prometheus ``histogram_quantile``)."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, cnt in enumerate(buckets):
        if cnt <= 0:
            continue
        if cum + cnt >= rank:
            if i >= len(boundaries):         # +Inf bucket
                return float(boundaries[-1]) if boundaries else None
            lo = float(boundaries[i - 1]) if i > 0 else 0.0
            hi = float(boundaries[i])
            frac = (rank - cum) / cnt
            return lo + (hi - lo) * frac
        cum += cnt
    return float(boundaries[-1]) if boundaries else None


def _fmt_tags(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def export_prometheus() -> str:
    """All registered metrics in Prometheus text exposition format."""
    lines = []
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        if m.description:
            lines.append(f"# HELP {m.name} {m.description}")
        kind = {"Counter": "counter", "Gauge": "gauge",
                "Histogram": "histogram"}[type(m).__name__]
        lines.append(f"# TYPE {m.name} {kind}")
        if isinstance(m, Histogram):
            for key, data in m.series().items():
                cumulative = 0
                bounds = [str(b) for b in m.boundaries] + ["+Inf"]
                for bound, count in zip(bounds, data["buckets"]):
                    cumulative += count
                    tag = dict(key)
                    tag["le"] = bound
                    lines.append(
                        f"{m.name}_bucket{_fmt_tags(tuple(sorted(tag.items())))} {cumulative}")
                lines.append(f"{m.name}_sum{_fmt_tags(key)} {data['sum']}")
                lines.append(f"{m.name}_count{_fmt_tags(key)} {data['count']}")
        else:
            for key, value in m.series().items():
                lines.append(f"{m.name}{_fmt_tags(key)} {value}")
    return "\n".join(lines) + "\n"
