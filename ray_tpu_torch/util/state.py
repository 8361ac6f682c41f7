"""State API: list/get/summarize cluster entities, the cluster metrics
and the cluster logs.

Port of the parts of ``ray_tpu/util/state.py`` that read the tables, the
metrics plane and the log plane: ``list_*``, ``summarize_*``,
``cluster_summary``, ``cluster_metrics``, ``cluster_metric_annexes``,
``summarize_latencies``, ``get_log``, ``list_logs`` and
``summarize_errors``. The tracing, stack, profiling, goodput and memory
readers wait for their planes (``list_objects`` in cluster mode asks the
memory plane's ``memory_table``, which the GCS does not serve yet).

Reference analog: ``python/ray/util/state/`` (StateResource enum
``common.py:71-87``) backed by the GCS + task events
(``dashboard/state_aggregator.py``, ``gcs_task_manager.cc``). Works in
both modes: local (in-process runtime introspection) and cluster (GCS
queries)."""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.runtime import core as _core


def _mode():
    if not _core.is_initialized():
        return None, None
    rt = _core.get_runtime()
    if hasattr(rt, "_gcs"):  # ClusterRuntime
        return "cluster", rt
    return "local", rt


def list_nodes() -> list[dict]:
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("get_nodes", alive_only=False)
    if mode == "local":
        return [{"node_id": rt.node_id.hex(), "alive": True,
                 "resources": rt.total_resources,
                 "available": rt.available_resources_snapshot()}]
    return []


def list_actors() -> list[dict]:
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("list_actors")
    if mode == "local":
        return [{"actor_id": a.actor_id.hex(), "name": a.name,
                 "state": "DEAD" if a.dead else "ALIVE",
                 "num_restarts": a.num_restarts}
                for a in rt._actors.values()]
    return []


def list_jobs() -> list[dict]:
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("list_jobs")
    if mode == "local":
        return [{"job_id": rt.job_id.hex(), "state": "RUNNING"}]
    return []


def list_placement_groups() -> list[dict]:
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("list_placement_groups")
    return []


def list_tasks(limit: int = 1000) -> list[dict]:
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("get_task_events", limit=limit)
    if mode == "local":
        return rt.task_events(limit) if hasattr(rt, "task_events") else []
    return []


def list_objects(limit: int = 10_000) -> list[dict]:
    """Per-object rows with a CONSISTENT field shape in both modes:
    ``{object_id, size_bytes, state, locations, holders, pins}``.
    ``state`` is one of in_memory / pinned / spilled / being_pulled;
    cluster mode joins the GCS object directory + ref tables with the
    per-node occupancy annexes for spill/pull state."""
    mode, rt = _mode()
    if mode == "local":
        if hasattr(rt.store, "entries"):
            return rt.store.entries(limit)
        return [{"object_id": k.hex() if hasattr(k, "hex") else str(k),
                 "size_bytes": 0, "state": "in_memory",
                 "locations": ["local"], "holders": [], "pins": 0}
                for k in getattr(rt.store, "_objects", {})]
    if mode == "cluster":
        table = rt._gcs.call("memory_table", limit=limit)["objects"]
        spilled, pulling = set(), set()
        for item in cluster_metric_annexes(prefix="mem/node/"):
            p = item.get("payload")
            if isinstance(p, dict):
                spilled.update(p.get("spilled_oids", ()))
                pulling.update(p.get("being_pulled_oids", ()))
        rows = []
        for oid, row in table.items():
            if oid in spilled:
                state = "spilled"
            elif oid in pulling:
                state = "being_pulled"
            elif row["locations"]:
                state = "pinned"   # directory entries are raylet-pinned
            else:
                state = "in_memory"
            rows.append({"object_id": oid,
                         "size_bytes": row["size"],
                         "state": state,
                         "locations": row["locations"],
                         "holders": row["holders"],
                         "pins": row["pins"]})
        rows.sort(key=lambda r: -r["size_bytes"])
        return rows
    return []


def summarize_actors() -> dict:
    counts: dict[str, int] = {}
    for a in list_actors():
        counts[a["state"]] = counts.get(a["state"], 0) + 1
    return counts


def summarize_tasks() -> dict:
    counts: dict[str, int] = {}
    for t in list_tasks():
        state = t.get("state", "UNKNOWN")
        counts[state] = counts.get(state, 0) + 1
    return counts


def cluster_summary() -> dict:
    mode, rt = _mode()
    if rt is None:
        return {"initialized": False}
    return {
        "initialized": True,
        "mode": mode,
        "nodes": len([n for n in list_nodes()
                      if n.get("alive", True)]),
        "actors": summarize_actors(),
        "resources_total": rt.cluster_resources(),
        "resources_available": rt.available_resources_snapshot(),
    }


# ---------------------------------------------------------------------------
# cluster metrics plane (runtime/metrics_plane.py): push-aggregated
# time series in the GCS, queried here — reference analog: the
# Prometheus endpoint the dashboard's Metrics tab queries
# ---------------------------------------------------------------------------


def cluster_metrics(name: str | None = None, *, tags: dict | None = None,
                    last_s: float | None = None, group_by=(),
                    per_window: bool = False) -> dict:
    """Query the GCS time-series store. ``name=None`` lists metric
    names; otherwise returns the merged aggregate over every window in
    range (``per_window=True`` for the raw range query). ``group_by``
    names tag keys to split on — ``["src"]`` gives per-process/per-node
    series. In local mode the process registry answers directly (one
    window, no ring buffer)."""
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("query_metrics", name=name, tags=tags,
                            last_s=last_s, group_by=tuple(group_by or ()),
                            per_window=per_window)
    from ray_tpu_torch.runtime.metrics_plane import MetricsStore
    from ray_tpu_torch.util import metrics as _metrics

    store = MetricsStore(window_s=3600.0)
    frame, _ = _metrics.snapshot_delta(None)
    store.ingest("local", frame)
    if name is None:
        return {"names": store.names()}
    return store.query(name, tags=tags, last_s=last_s,
                       group_by=group_by, per_window=per_window)


def cluster_metric_annexes(prefix: str = "",
                           max_age_s: float | None = None) -> list[dict]:
    """[{src, key, ts, payload}] annexes piggybacked on metrics frames
    (e.g. serve prefix-cache digests under ``serve/prefix_digest/``).
    Cluster mode queries the GCS store; local mode reads the process
    annex registry (``runtime/annex.py``) directly (every local-mode
    replica shares it)."""
    mode, rt = _mode()
    if mode == "cluster":
        return rt._gcs.call("query_metric_annexes", prefix=prefix,
                            max_age_s=max_age_s)["annexes"]
    import time as _time

    from ray_tpu_torch.runtime import annex as _annex

    now = _time.time()
    items = [(k, ts, payload)
             for k, (ts, payload) in _annex.local_annexes().items()
             if k.startswith(prefix)
             and (max_age_s is None or now - ts <= max_age_s)]
    items.sort(key=lambda it: -it[1])
    return [{"src": "local", "key": k, "ts": ts, "payload": payload}
            for k, ts, payload in items]


def summarize_latencies(last_s: float | None = 300.0,
                        quantiles=(0.5, 0.95, 0.99)) -> dict:
    """Digest of every cluster latency histogram: count / mean / p50 /
    p95 / p99 per metric over the window — the one-call answer to
    "where is the time going right now"."""
    from ray_tpu_torch.runtime.metrics_plane import summarize_histogram

    names = cluster_metrics().get("names", {})
    out = {}
    for name, kind in sorted(names.items()):
        if kind != "histogram":
            continue
        res = cluster_metrics(name, last_s=last_s)
        digest = summarize_histogram(res, quantiles=quantiles)
        if digest.get("count"):
            out[name] = digest
    return out


# ---------------------------------------------------------------------------
# cluster log plane (runtime/log_plane.py): captured stdout/stderr in
# the GCS LogStore, task-attributed via the logs/segments/* annexes —
# reference analog: ray.util.state.get_log / list_logs
# ---------------------------------------------------------------------------


def get_log(proc: str | None = None, task_id: str | None = None,
            follow: bool = False, tail: int = 100):
    """Captured log lines for one process (``proc`` — a proc name like
    ``worker-ab12cd34ef56``, a worker-id prefix, ``raylet-...``, or
    ``gcs``) or exactly one task's attributed segment (``task_id`` —
    resolved through the offset annex the emitting worker pushed).

    Returns a dict ``{proc, lines, ...}``; with ``follow=True`` (proc
    mode only) returns a generator yielding each new line dict as it
    reaches the store, polling forever — iterate with a consumer-side
    stop condition."""
    mode, rt = _mode()
    if mode != "cluster":
        # local mode: serve from this process's own capture, if any
        from ray_tpu_torch.runtime import log_plane as _lp

        cap = _lp.active_capture()
        if cap is None:
            return {"proc": proc, "lines": [],
                    "error": "no cluster runtime and no local capture"}
        return {"proc": cap.proc, "lines": cap.tail(tail, task_id)}
    if task_id is not None:
        return rt._gcs.call("get_log", task_id=task_id)
    if not proc:
        raise ValueError("get_log needs proc or task_id")
    if not follow:
        return rt._gcs.call("get_log", proc=proc, tail=tail)

    def _follow():
        import time as _time

        cursor = None
        first = rt._gcs.call("get_log", proc=proc, tail=tail)
        while True:
            for rec in first.get("lines") or []:
                cursor = (rec["file"], rec["offset"])
                yield rec
            _time.sleep(0.5)
            first = rt._gcs.call("get_log", proc=proc, tail=1000,
                                 after=cursor)

    return _follow()


def list_logs() -> dict:
    """Every process with stored lines: ``{procs: {name: {node, pid,
    lines, last_ts, files}}, ingested, deduped}``."""
    mode, rt = _mode()
    if mode != "cluster":
        from ray_tpu_torch.runtime import log_plane as _lp

        cap = _lp.active_capture()
        if cap is None:
            return {"procs": {}, "ingested": 0, "deduped": 0}
        return {"procs": {cap.proc: {"node": "local", "pid": None,
                                     "lines": cap.lines,
                                     "last_ts": None,
                                     "files": [cap.file_token()]}},
                "ingested": cap.lines, "deduped": 0}
    return rt._gcs.call("list_logs")


def summarize_errors(last_s: float | None = None) -> list[dict]:
    """Deduplicated error groups (ERROR/CRITICAL/FATAL lines and final
    traceback lines, signature-normalized): ``[{signature, sample,
    count, first_ts, last_ts, procs, traces, tasks}]`` sorted by count.
    ``traces`` links each group to its distributed traces when the line
    was emitted inside a span."""
    mode, rt = _mode()
    if mode != "cluster":
        from ray_tpu_torch.runtime import log_plane as _lp

        groups: dict = {}
        for rec in _lp.log_tail(None):
            if not _lp.is_error_line(rec["line"]):
                continue
            sig = _lp.error_signature(rec["line"])
            g = groups.setdefault(sig, {
                "signature": sig, "sample": rec["line"], "count": 0,
                "first_ts": rec["ts"], "last_ts": rec["ts"],
                "procs": set(), "traces": set(), "tasks": set()})
            g["count"] += 1
            g["first_ts"] = min(g["first_ts"], rec["ts"])
            g["last_ts"] = max(g["last_ts"], rec["ts"])
            if rec.get("trace"):
                g["traces"].add(rec["trace"])
            if rec.get("task"):
                g["tasks"].add(rec["task"])
        import time as _time

        now = _time.time()
        out = [dict(g) for g in groups.values()
               if last_s is None or now - g["last_ts"] <= last_s]
        for g in out:
            g["procs"], g["traces"], g["tasks"] = (
                sorted(g["procs"]), sorted(g["traces"]),
                sorted(g["tasks"]))
        out.sort(key=lambda g: (-g["count"], -g["last_ts"]))
        return out
    return rt._gcs.call("summarize_errors", last_s=last_s)["groups"]
