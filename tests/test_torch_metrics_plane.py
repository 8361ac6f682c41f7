"""The port's metrics plane against the JAX package's, on the CPU.

``ray_tpu_torch.util.metrics`` and ``ray_tpu.util.metrics`` take the same
observations and must give equal snapshots, delta frames and quantiles
and a byte-equal Prometheus export; each package's ``MetricsStore`` takes
its own package's frames at the same (patched) clock readings and must
answer every query alike, and so must ``summarize_histogram``. Then what
JAX's ``tests/test_metrics_plane.py`` holds of the pusher (the claim is
exclusive in the process; its buffer stays bounded against a dead GCS),
an observation that makes no RPC on the calling thread, the port's GCS
serving the plane's RPCs (and dropping a retracted annex set), and the
serve autoscaler reading the plane (``autoscale_mode`` "metrics") with
JAX's decisions for the same ongoing counts, on the in-process runtimes.
"""

import socket
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.runtime import metrics_plane as jmp
from ray_tpu.serve import controller as jcontroller
from ray_tpu.util import metrics as jm
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.runtime import annex as tannex
from ray_tpu_torch.runtime import metrics_plane as tmp
from ray_tpu_torch.serve import controller as tcontroller
from ray_tpu_torch.util import metrics as tm

PACKAGES = {"jax": (jm, jmp), "torch": (tm, tmp)}


@pytest.fixture(autouse=True)
def _own_registries():
    """Each test starts from empty registries; the metrics other modules
    registered (the serve engines' histograms) come back afterwards."""
    saved = {name: dict(m._registry) for name, (m, _) in PACKAGES.items()}
    for m, _ in PACKAGES.values():
        m.clear_registry()
        m.set_enabled(None)
    yield
    for name, (m, _) in PACKAGES.items():
        m.clear_registry()
        m._registry.update(saved[name])
        m.set_enabled(None)


def observe_all(m):
    """The same observations through one package's registry."""
    c = m.counter("t_ops", "ops by kind", tag_keys=("op",))
    c.inc(tags={"op": "put"})
    c.inc(2, tags={"op": "get"})
    g = m.gauge("t_inflight")
    g.set(7)
    g.set(3, tags={"replica": "r1"})
    h = m.histogram("t_lat", "latency", boundaries=(0.01, 0.1, 1.0))
    handle = h.handle({"stage": "grant"})
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        handle.observe(v)
    h.observe(0.07, tags={"stage": "ready"})
    frame1, prev = m.snapshot_delta(None)
    c.inc(3, tags={"op": "put"})
    handle.observe(0.2)
    g.set(9)
    frame2, prev = m.snapshot_delta(prev)
    frame3, _ = m.snapshot_delta(prev)
    hist = m.snapshot()["t_lat"]["series"][(("stage", "grant"),)]
    quantiles = [m.quantile_from_buckets((0.01, 0.1, 1.0),
                                         hist["buckets"], q)
                 for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)]
    return {"snapshot": m.snapshot(), "frames": [frame1, frame2, frame3],
            "quantiles": quantiles, "prometheus": m.export_prometheus(),
            "merged": m.merge_hist(dict(hist), hist),
            "empty_quantile": m.quantile_from_buckets((1.0,), [0, 0], 0.5)}


def test_registry_snapshots_frames_and_export_equal():
    want = observe_all(jm)
    got = observe_all(tm)
    assert got == want
    # idle: counters and histograms ship nothing, gauges their value
    assert set(want["frames"][2]) == {"t_inflight"}
    assert want["frames"][1]["t_ops"]["series"] == {(("op", "put"),): 3.0}
    assert want["prometheus"].encode() == got["prometheus"].encode()
    assert 'le="+Inf"' in got["prometheus"]


def test_enabled_switch_and_get_or_create():
    tm.set_enabled(False)
    assert tm.enabled() is False
    tm.set_enabled(None)
    assert tm.enabled() is True
    h = tm.histogram("t_same")
    assert tm.histogram("t_same") is h
    assert tm.counter("t_same") is not h    # another kind replaces it


class _Clock:
    """A fake ``time`` module for both stores: every reading is set."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


def _store_answers(mp, frames_at, clock) -> dict:
    store = mp.MetricsStore(window_s=5.0, windows=3)
    rolled = []
    store._on_roll = lambda w: rolled.append((w["start"], w["end"]))
    out = {}
    for t, src, frame in frames_at:
        clock.now = t
        store.ingest(src, frame)
    clock.now = frames_at[-1][0] + 1.0
    q = store.query
    out["names"] = store.names()
    out["all"] = q("t_lat")
    out["by_src"] = q("t_lat", group_by=("src",))
    out["by_stage_src"] = q("t_lat", group_by=("stage", "src"))
    out["tag_filter"] = q("t_lat", tags={"stage": "grant", "src": "b"})
    out["last_s"] = q("t_lat", last_s=3.0)
    out["per_window"] = q("t_lat", per_window=True)
    out["counter"] = q("t_ops", group_by=("op",))
    out["gauge"] = q("t_inflight", group_by=("src",))
    out["unknown"] = q("nope")
    out["digest"] = mp.summarize_histogram(out["all"])
    out["digest_q"] = mp.summarize_histogram(out["by_src"],
                                             quantiles=(0.5, 0.75))
    # a quiet plane: the first query rolls the current window (stamped
    # now), a later one finds every window out of a short horizon
    clock.now += 100.0
    out["rolled_fresh"] = q("t_lat", last_s=1.0)
    clock.now += 100.0
    out["aged"] = q("t_lat", last_s=1.0)
    out["rolled"] = rolled
    return out


def test_metrics_store_queries_equal(monkeypatch):
    want_frames = observe_all(jm)["frames"]
    got_frames = observe_all(tm)["frames"]
    assert got_frames == want_frames
    answers = {}
    for name, (_, mp), frames in (("jax", PACKAGES["jax"], want_frames),
                                  ("torch", PACKAGES["torch"], got_frames)):
        clock = _Clock()
        monkeypatch.setattr(mp, "time", clock)
        # two sources, three windows of 5 s: the gauge's later window
        # wins, counters and histograms add across windows and sources
        frames_at = [(1000.0, "a", frames[0]), (1001.0, "b", frames[0]),
                     (1006.0, "a", frames[1]), (1012.0, "b", frames[1])]
        answers[name] = _store_answers(mp, frames_at, clock)
    assert answers["torch"] == answers["jax"]
    a = answers["jax"]
    assert a["all"]["windows"] == 3 and len(a["rolled"]) == 3
    assert a["digest"]["count"] == 14
    assert {g["tags"]["src"]: g["value"] for g in a["gauge"]["groups"]} \
        == {"a": 12.0, "b": 12.0}     # 9 + 3: tag sets sum
    assert a["aged"]["kind"] is None


def test_store_annexes_latest_wins_and_age(monkeypatch):
    answers = {}
    for name, (_, mp) in PACKAGES.items():
        clock = _Clock()
        monkeypatch.setattr(mp, "time", clock)
        store = mp.MetricsStore()
        store.put_annexes("a", {"serve/prefix_digest/r0": {"n": 1},
                                "logs/segments/w": [1]})
        clock.now = 1010.0
        store.put_annexes("b", {"serve/prefix_digest/r1": {"n": 2}})
        store.put_annexes("a", {"serve/prefix_digest/r0": {"n": 3}})
        answers[name] = (store.annexes("serve/"),
                         store.annexes("", max_age_s=5.0),
                         store.annexes("logs/"))
    assert answers["torch"] == answers["jax"]
    assert answers["jax"][2] == []      # a's new set retracted the key


# -- the pusher (tests/test_metrics_plane.py:156-191) -------------------


def test_pusher_claim_is_process_exclusive():
    # a runtime of another module may hold the claim: park it
    held = tmp._claimed
    tmp._claimed = None
    try:
        assert tmp.claim_pusher("owner-a")
        assert tmp.claim_pusher("owner-a")          # re-claim by owner
        assert not tmp.claim_pusher("owner-b")      # second owner: refused
        tmp.release_pusher("owner-a")
        assert tmp.claim_pusher("owner-b")
        tmp.release_pusher("owner-b")
    finally:
        tmp._claimed = held


def test_pusher_buffer_bounded_against_dead_gcs():
    c = tm.counter("t_push")
    # nothing listens here: every push fails fast (connection refused)
    pusher = tmp.MetricsPusher(("127.0.0.1", 1), src="t", interval_s=60.0)
    cap = pusher._buf_cap
    for _ in range(cap + 3):
        c.inc()
        pusher.flush_now()
    assert len(pusher._buf) <= cap
    assert pusher.dropped >= 3
    assert pusher.pushed == 0
    pusher.stop()


def test_observation_makes_no_rpc_on_the_calling_thread(monkeypatch):
    """In place of JAX's timing ratio: a pusher runs (against a dead
    address), and a burst of observations on this thread dials, sends
    and receives nothing here."""
    me = threading.get_ident()
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, threading.get_ident()))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(socket, "create_connection",
                        spy("dial", socket.create_connection))
    for meth in ("connect", "send", "sendall", "recv", "recv_into"):
        monkeypatch.setattr(socket.socket, meth,
                            spy(meth, getattr(socket.socket, meth)))
    held = tmp._claimed
    tmp._claimed = None
    pusher = tmp.MetricsPusher(("127.0.0.1", 1), src="spy",
                               interval_s=0.01).start()
    try:
        h = tm.histogram("t_hot", boundaries=(0.1, 1.0)).handle(
            {"stage": "x"})
        c, g = tm.counter("t_hot_n"), tm.gauge("t_hot_g")
        for i in range(5000):
            h.observe(i * 1e-4)
            c.inc()
            g.set(i)
        time.sleep(0.1)          # the pusher's thread ticks meanwhile
    finally:
        pusher.stop()
        tmp._claimed = held
    assert not [c for c in calls if c[1] == me]
    assert [c for c in calls if c[1] != me], "the pusher never dialed"
    assert tm.snapshot()["t_hot"]["series"][(("stage", "x"),)][
        "count"] == 5000


def test_gcs_serves_the_metrics_rpcs():
    """The port's GCS: a pusher's frames and annexes through
    push_metrics; query_metrics and query_metric_annexes answer; a
    retracted annex leaves the pusher's set there with its next push."""
    from ray_tpu_torch.runtime.gcs import GcsServer
    from ray_tpu_torch.runtime.rpc import RpcClient

    saved = tannex.local_annexes()
    for key in saved:
        tannex.set_annex(key, None)
    held = tmp._claimed
    tmp._claimed = None
    gcs = GcsServer().start()
    client = RpcClient(gcs.address)
    try:
        tm.histogram("t_gcs", boundaries=(1.0,)).observe(0.5)
        tannex.set_annex("serve/prefix_digest/t", {"tag": "t"})
        tannex.set_annex("logs/segments/w", [{"task": "x"}])
        pusher = tmp.MetricsPusher(gcs.address, src="p1", interval_s=60.0)
        pusher.flush_now()
        res = client.call("query_metrics", name="t_gcs",
                          group_by=("src",))
        assert [(g["tags"], g["value"]["count"]) for g in res["groups"]] \
            == [({"src": "p1"}, 1)]
        assert "t_gcs" in client.call("query_metrics")["names"]
        got = client.call("query_metric_annexes", prefix="serve/")
        assert [a["payload"] for a in got["annexes"]] == [{"tag": "t"}]
        tannex.set_annex("serve/prefix_digest/t", None)
        pusher.flush_now()
        assert client.call("query_metric_annexes",
                           prefix="serve/")["annexes"] == []
        assert [a["key"] for a in client.call(
            "query_metric_annexes")["annexes"]] == ["logs/segments/w"]
        pusher.stop()
        for name in ("memory_table", "push_spans", "profile"):
            with pytest.raises(NotImplementedError):
                client.call(name)
    finally:
        client.close()
        gcs.stop()
        tmp._claimed = held
        for key, (_, payload) in saved.items():
            tannex.set_annex(key, payload)


# -- the serve autoscaler on the plane -----------------------------------


def _decisions(controller_mod, m, ongoing_counts) -> list:
    """One controller's ``_autoscale_once`` on a two-replica deployment
    whose replicas' pushed gauges read each ongoing count in turn (its
    control loop never started: a bare instance)."""
    ctl = object.__new__(controller_mod.ServeController)
    ctl._lock = threading.RLock()
    auto = {"min_replicas": 1, "max_replicas": 4,
            "target_ongoing_requests": 2.0, "upscale_delay_s": 0.0,
            "downscale_delay_s": 0.0, "metrics_window_s": 60.0}
    dep = {"config": {"autoscaling": auto}, "replicas": ["r0", "r1"],
           "target": 2, "last_scale": -1e9}
    ctl._deployments = {"AutoDep": dep}
    g = m.gauge("ray_tpu_serve_ongoing", tag_keys=("deployment", "replica"))
    kv = m.gauge("ray_tpu_serve_kv_pages",
                 tag_keys=("state", "deployment", "replica"))
    out = []
    for n in ongoing_counts:
        for i, r in enumerate(("r0", "r1")):
            g.set(n // 2 + (i < n % 2),
                  tags={"deployment": "AutoDep", "replica": r})
            kv.set(10, tags={"state": "total", "deployment": "AutoDep",
                             "replica": r})
            kv.set(10 if n < 9 else 0,
                   tags={"state": "free", "deployment": "AutoDep",
                         "replica": r})
        dep["last_scale"] = -1e9
        ctl._autoscale_once()
        out.append((n, dep["autoscale_mode"], dep["target"]))
    return out


def test_autoscale_decisions_equal_on_the_pushed_signals():
    counts = [0, 1, 4, 5, 9, 12, 2, 0]
    want = _decisions(jcontroller, jm, counts)
    got = _decisions(tcontroller, tm, counts)
    assert got == want
    assert {mode for _, mode, _ in want} == {"metrics"}
    targets = [t for _, _, t in want]
    assert max(targets) > 2 and min(targets) < 2


def test_controller_retracts_the_digests_of_its_replicas():
    """Deleting a deployment, or shutting the controller down, retracts
    its replicas' (and draining replicas') prefix digests from the
    process's registry; another deployment's stays."""
    saved = tannex.local_annexes()
    for key in saved:
        tannex.set_annex(key, None)
    try:
        ctl = object.__new__(tcontroller.ServeController)
        ctl._lock = threading.RLock()
        ctl._version = 0
        ctl._deployments = {
            name: {"replicas": [], "tags": [f"{name}#r0"],
                   "draining": [{"replica": None, "tag": f"{name}#r1"}]}
            for name in ("a", "b")}
        for tag in ("a#r0", "a#r1", "b#r0", "b#r1", "c#r0"):
            tannex.set_annex(f"serve/prefix_digest/{tag}", {"tag": tag})

        def left():
            return sorted(k.rpartition("/")[2]
                          for k in tannex.local_annexes())

        ctl.delete_deployment("a")
        assert left() == ["b#r0", "b#r1", "c#r0"]
        ctl.shutdown()
        assert left() == ["c#r0"]
    finally:
        for key in tannex.local_annexes():
            tannex.set_annex(key, None)
        for key, (_, payload) in saved.items():
            tannex.set_annex(key, payload)


class SlowMetrics:
    def __call__(self, secs):
        time.sleep(secs)
        return "ok"


def autoscaling_up_metrics(pkg, serve):
    handle = serve.run(serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3, "policy": "metrics",
        "target_ongoing_requests": 1.0, "upscale_delay_s": 0.1,
        "downscale_delay_s": 60.0}, max_concurrent_queries=4)(
            SlowMetrics).bind())
    refs = [handle.remote(0.4) for _ in range(12)]
    deadline = time.monotonic() + 15
    scaled = False
    while time.monotonic() < deadline and not scaled:
        dep = serve.status()["deployments"]["SlowMetrics"]
        scaled = dep["running"] >= 2
        time.sleep(0.05)
    mode = serve.status()["deployments"]["SlowMetrics"]["autoscale_mode"]
    return scaled, mode, pkg.get(refs)


def test_autoscaling_reads_the_plane_on_the_in_process_runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    try:
        want = autoscaling_up_metrics(ray_tpu, jserve)
        jserve.shutdown()
        got = autoscaling_up_metrics(ray_tpu_torch, tserve)
        tserve.shutdown()
    finally:
        jserve.shutdown()
        tserve.shutdown()
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()
    assert want == (True, "metrics", ["ok"] * 12)
    assert got == want
