"""The port's log plane against the JAX package's, on the CPU.

The capture file contract (stamps, epoch headers, rotation under its byte
cap) read by both packages' parsers; the error classifier and signature
on a fixed list; each package's ``LogStore`` fed the same entries at the
same (patched) clock readings, answering ``tail``, ``segment``, ``list``
and ``summarize_errors`` alike, duplicate frames idempotent and epochs in
order. Then, on one port cluster for the module (an in-process head node
and a raylet process of its own), the contracts of JAX's
``tests/test_log_plane.py``: ``get_log`` by task id returns exactly the
task's lines, ``get_log`` by process and ``list_logs`` (the raylet
process too), the driver's echo with its ``(fn pid=N, node=M)`` prefix
from an actor on the other raylet, its rate limit and its opt-out, and
``summarize_errors`` folding two raises into one group. The task bodies
live in ``tests/torch_plane_tasks.py``.
"""

import os
import time

import pytest

import ray_tpu_torch
import torch_plane_tasks as tasks
from ray_tpu.runtime import log_plane as jlp
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.runtime import log_plane as tlp
from ray_tpu_torch.util import state
from ray_tpu_torch.utils.config import get_config, reset_config

PUSH_S = "0.25"


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


# -- capture and parsers (no cluster) ------------------------------------


def test_capture_rotation_under_byte_cap(tmp_path):
    cap = tlp.LogCapture("rotor", str(tmp_path), max_bytes=2048,
                         rotate_count=2)
    line = "rotation-payload-" + "x" * 80
    for _ in range(200):
        cap.emit("o", line)
    cap.close()
    names = sorted(os.listdir(tmp_path))
    assert names == ["rotor.log", "rotor.log.1", "rotor.log.2"]
    # every generation respects the byte cap (+ one line of slack: the
    # rotation check runs after the write that crossed the cap)
    for name in names:
        assert os.path.getsize(tmp_path / name) <= 2048 + len(line) + 64
    epochs = []
    for name in names:
        first = (tmp_path / name).read_bytes().split(b"\n", 1)[0].decode()
        assert tlp.parse_epoch(first) == jlp.parse_epoch(first) is not None
        epochs.append(tlp.parse_epoch(first))
    assert len(set(epochs)) == len(epochs) and cap.epoch == max(epochs)


def test_stamps_round_trip_through_both_parsers(tmp_path):
    for lp, name in ((tlp, "port"), (jlp, "jax")):
        cap = lp.LogCapture(name, str(tmp_path), max_bytes=1 << 20)
        with cap.task_span("t-123", "fn name", "job A", "trace-9"):
            cap.emit("e", "inside the span\twith a tab")
        cap.emit("o", "outside")
        cap.close()
        seg = cap._segments[-1]
        assert seg["task"] == "t-123" and seg["end"] > seg["start"]
    port = (tmp_path / "port.log").read_text().splitlines()
    jax = (tmp_path / "jax.log").read_text().splitlines()
    assert len(port) == len(jax) == 3
    for lines in (port, jax):
        for ln in lines:
            a, b = tlp.parse_line(ln), jlp.parse_line(ln)
            if a is None:
                assert b is None and tlp.parse_epoch(ln) == 0
                continue
            assert a[1:] == b[1:] and a[0] == b[0]
    ts, stream, trace, task, name, job, text = tlp.parse_line(port[1])
    assert (stream, trace, task, name, job, text) == \
        ("e", "trace-9", "t-123", "fn_name", "job_A",
         "inside the span\twith a tab")
    assert tlp.parse_line(port[2])[3] is None
    # the headers differ only in their timestamps
    assert [ln.split(" ", 1)[1] for ln in port[1:]] == \
        [ln.split(" ", 1)[1] for ln in jax[1:]]
    # an unstamped line keeps its text
    assert tlp.parse_line("raw crash output")[1:] == \
        jlp.parse_line("raw crash output")[1:]


ERROR_LINES = [
    "ValueError: bad thing", "2026-01-01 ERROR something failed",
    '  File "x.py", line 3, in f', "Traceback (most recent call last):",
    "all good here", "KeyboardInterrupt", "SystemExit: 3",
    "CRITICAL disk at 99%", "an error: lowercase is not leveled",
    "torch.cuda.OutOfMemoryError: CUDA out of memory",
    "RAY_TPU_CRASH point=worker.mid_task rule=r7 pid=1234",
    "tail of a line RAY_TPU_CRASH point=raylet.x rule=q",
    "ValueError: boom #17 at 0xdeadbeef id 0123456789abcdef",
    "ValueError: boom #42 at 0xfeedface id fedcba9876543210",
]


def test_error_classifier_and_signature_agree():
    got = [(tlp.is_error_line(s), tlp.error_signature(s),
            tlp.crash_point(s)) for s in ERROR_LINES]
    want = [(jlp.is_error_line(s), jlp.error_signature(s),
             jlp.crash_point(s)) for s in ERROR_LINES]
    assert got == want
    assert [g[0] for g in got][:5] == [True, True, False, False, False]
    assert got[-1][1] == got[-2][1]          # numbers and ids folded
    assert got[10][2] == "worker.mid_task"


def test_install_capture_task_context_and_tails(tmp_path, capsys):
    cap = tlp.install_capture("flighty", log_dir=str(tmp_path))
    try:
        assert cap is not None and tlp.install_capture("x") is cap
        with tlp.task_context("task-ft", "fn", None, "tr-0042"):
            assert tlp.current_task_id() == "task-ft"
            print("flight-line-one")
            print("flight-line-two")
        print("untagged")
        assert tlp.current_task_id() is None
        assert [r["line"] for r in tlp.log_tail(3)] == \
            ["flight-line-one", "flight-line-two", "untagged"]
        assert tlp.recent_lines("task-ft", 5) == \
            ["flight-line-one", "flight-line-two"]
        events = tlp.chrome_instant_events()
        assert [e["name"] for e in events if e["tid"] == "tr-0042"] == \
            ["flight-line-one", "flight-line-two"]
        with tlp.label_context("App/replica-ab12"):
            print("labelled")
        assert cap.tail(1)[0]["name"] == "App/replica-ab12"
        drained = cap.drain_records()
        assert [r["line"] for r in drained][-1] == "labelled"
    finally:
        tlp.uninstall_capture()
    assert tlp.active_capture() is None
    # the tee wrote the file, not the terminal
    assert "flight-line-one" not in capsys.readouterr().out
    stamped = [tlp.parse_line(ln) for ln in
               (tmp_path / "flighty.log").read_text().splitlines()]
    assert [p[3] for p in stamped if p and p[6].startswith("flight")] == \
        ["task-ft", "task-ft"]


# -- the GCS-side store ------------------------------------------------------


def _entry(proc="worker-abc", file="worker-abc.log@1", offs=(10, 30, 55),
           text="line-at-{off}", task=None, ts=1000.0):
    lines = [(off, ts + off / 100, "o", text.format(off=off), None, task,
              None, None) for off in offs]
    return {"proc": proc, "pid": 7, "file": file, "lines": lines}


FEED = [
    ("node-1", [_entry()]),
    ("node-1", [_entry()]),                          # exact replay
    ("node-1", [_entry(offs=(30, 55, 80))]),          # partial overlap
    ("node-1", [_entry(file="worker-abc.log@2", offs=(10,))]),
    ("node-2", [_entry(proc="worker-def", file="worker-def.log@0",
                       offs=(5, 9, 40), task="t-1",
                       text="ValueError: boom #{off}")]),
    ("node-2", [_entry(proc="raylet-def", file="raylet-def.out@0",
                       offs=(3,), text="RAY_TPU_CRASH point=p rule=r")]),
]
for _epoch in range(9, 12):
    FEED.append(("node-3", [_entry(proc="worker-ghi",
                                   file=f"worker-ghi.log@{_epoch}",
                                   offs=(10,))]))


class _Clock:
    def __init__(self):
        self.now = 2000.0

    def time(self):
        return self.now


def _store_answers(lp, clock) -> dict:
    store = lp.LogStore(lines_per_proc=16, error_groups=8)
    accepted = [store.ingest(node, entries) for node, entries in FEED]
    seg = {"task": "t-1", "proc": "worker-def", "file": "worker-def.log@0",
           "start": 5, "end_file": "worker-def.log@0", "end": 40}
    out = {"accepted": accepted, "deduped": store.deduped,
           "tail": store.tail("worker-abc"),
           "tail_n": store.tail("abc", n=2),
           "cursor": store.tail("worker-ghi",
                                after=("worker-ghi.log@10", 10)),
           "missing": store.tail("nobody"),
           "segment": store.segment(seg),
           "list": store.list(),
           "errors": store.summarize_errors()}
    clock.now += 1e6
    out["errors_recent"] = store.summarize_errors(last_s=60.0)
    return out


def test_log_store_answers_equal(monkeypatch):
    answers = {}
    for name, lp in (("jax", jlp), ("torch", tlp)):
        clock = _Clock()
        monkeypatch.setattr(lp, "time", clock)
        answers[name] = _store_answers(lp, clock)
    assert answers["torch"] == answers["jax"]
    a = answers["jax"]
    assert a["accepted"][1] == [] and a["deduped"] == 5
    assert [r[0] for r in a["accepted"][2][0]["lines"]] == [80]
    # epoch 11 after a cursor at epoch 10 (numeric, not lexicographic)
    assert [r["file"] for r in a["cursor"]["lines"]] == \
        ["worker-ghi.log@11"]
    assert [r["offset"] for r in a["segment"]["lines"]] == [5, 9]
    groups = {g["kind"]: g for g in a["errors"]}
    assert groups["error"]["count"] == 3 and groups["error"]["tasks"] == \
        ["t-1"]
    assert groups["crash"]["crash_point"] == "p"
    assert a["errors_recent"] == []


# -- one cluster for the module ---------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    """An in-process head {CPU 2} and a raylet process {CPU 1, ext 1};
    pushes every 0.25 s (workers inherit the flag); the driver echoes."""
    saved = {k: os.environ.get(k) for k in
             ("RAY_TPU_METRICS_PUSH_INTERVAL_S", "OMP_NUM_THREADS")}
    os.environ["RAY_TPU_METRICS_PUSH_INTERVAL_S"] = PUSH_S
    os.environ["OMP_NUM_THREADS"] = "1"
    reset_config()
    ray_tpu_torch.shutdown()
    c = Cluster()
    try:
        c.add_node(num_cpus=2)
        ext = c.add_node(num_cpus=1, resources={"ext": 1}, external=True)
        c.wait_for_nodes(2)
        ray_tpu_torch.init(address=c.gcs_address)
        yield c, ext
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_config()


def _echoed(capsys, needle, timeout=20.0) -> str:
    seen = ""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        cap = capsys.readouterr()
        seen += cap.out + cap.err
        if needle in seen:
            break
        time.sleep(0.1)
    return seen


def test_get_log_by_task_id_returns_exact_segment(cluster):
    tid = ray_tpu_torch.get(ray_tpu_torch.remote(tasks.attributed).remote())
    assert tid, "worker did not bind a task id during execution"

    def fetch():
        out = state.get_log(task_id=tid)
        return out if out.get("lines") else None

    out = _wait(fetch, 20, f"attributed segment for task {tid}")
    assert [r["line"] for r in out["lines"]] == \
        ["attr-line-one-corge", "attr-line-two-corge"]
    assert all(r["task"] in (tid, None) for r in out["lines"])
    assert state.get_log(task_id="no-such-task")["error"]


def test_get_log_by_proc_and_list_logs(cluster):
    assert ray_tpu_torch.get(ray_tpu_torch.remote(tasks.speak).remote(
        "garply")) == 1

    def worker_proc():
        procs = state.list_logs().get("procs") or {}
        hits = [p for p in procs if p.startswith("worker-")
                and any("garply" in r["line"] for r in
                        state.get_log(proc=p, tail=50)["lines"])]
        return hits[0] if hits else None

    proc = _wait(worker_proc, 20, "the sentinel in a stored worker tail")
    rec = next(r for r in state.get_log(proc=proc, tail=50)["lines"]
               if "garply" in r["line"])
    assert rec["stream"] == "o" and rec["task"]
    listing = state.list_logs()
    assert listing["ingested"] > 0 and listing["procs"][proc]["lines"] > 0
    assert listing["procs"][proc]["files"] and \
        state.get_log(proc="nobody")["error"]


def test_worker_histogram_reaches_the_gcs_by_src(cluster):
    wid = ray_tpu_torch.get(ray_tpu_torch.remote(tasks.observed).remote(
        0.05))

    def counts():
        res = state.cluster_metrics("t_worker_seconds", group_by=("src",))
        return {g["tags"]["src"]: g["value"]["count"]
                for g in res.get("groups", ())} or None

    got = _wait(counts, 5 * float(PUSH_S) + 5, "the worker's histogram")
    assert got == {wid[:12]: 1}
    digest = state.summarize_latencies(last_s=None)
    assert digest["t_worker_seconds"]["count"] == 1


def test_echo_prefix_and_get_log_from_the_other_raylet(cluster, capsys):
    chatter = ray_tpu_torch.remote(tasks.Chatter).options(
        resources={"ext": 1}).remote()
    tid = ray_tpu_torch.get(chatter.chat.remote("multiproc-actor-xyzzy"),
                            timeout=60)
    assert tid
    seen = _echoed(capsys, "multiproc-actor-xyzzy")
    line = next((ln for ln in seen.splitlines()
                 if "multiproc-actor-xyzzy" in ln), None)
    assert line is not None, f"actor print never echoed; saw {seen[-2000:]}"
    assert line.startswith("(") and " pid=" in line and "node=" in line
    out = _wait(lambda: state.get_log(task_id=tid).get("lines"), 25,
                "the actor method's segment")
    assert [r["line"] for r in out] == ["multiproc-actor-xyzzy"]
    assert out[0]["stream"] == "e"
    _, ext = cluster
    raylet = f"raylet-{ext.node_id[:12]}"
    _wait(lambda: raylet in state.list_logs()["procs"], 20,
          "the raylet process in list_logs")
    ray_tpu_torch.kill(chatter)


def test_echo_rate_limit_suppresses_floods(cluster, capsys, monkeypatch):
    monkeypatch.setattr(get_config(), "log_echo_rate_lines_s", 5.0)
    assert ray_tpu_torch.get(ray_tpu_torch.remote(tasks.flood).remote(80))
    seen = _echoed(capsys, "flood-line")
    # a later line from the same process reports what was swallowed
    time.sleep(1.0)
    assert ray_tpu_torch.get(ray_tpu_torch.remote(tasks.trickle).remote())
    seen += _echoed(capsys, "suppressed by the echo rate limit")
    echoed = [ln for ln in seen.splitlines() if "flood-line" in ln]
    assert echoed, "no flood lines reached the driver at all"
    assert len(echoed) < 60, f"the limit let {len(echoed)}/80 through"
    assert "suppressed by the echo rate limit" in seen


def test_summarize_errors_dedups_into_one_group(cluster):
    f = ray_tpu_torch.remote(tasks.boom)
    for i in (17, 42):
        with pytest.raises(Exception):
            ray_tpu_torch.get(f.remote(i))

    def group():
        hits = [g for g in state.summarize_errors()
                if "boom-sentinel" in g["sample"]]
        return hits if hits and hits[0]["count"] >= 2 else None

    hits = _wait(group, 25, "the deduplicated boom-sentinel group")
    assert len(hits) == 1 and hits[0]["count"] == 2
    g = hits[0]
    assert g["first_ts"] <= g["last_ts"] and g["procs"]
    assert len(g["tasks"]) == 2


def test_echo_opt_out_and_shutdown_joins_the_echo(cluster, capsys):
    c, _ = cluster
    rt = ray_tpu_torch.api._core.get_runtime()
    sub = rt._log_sub
    assert sub is not None and sub._thread.is_alive()
    ray_tpu_torch.shutdown()
    assert not sub._thread.is_alive(), "the echo thread outlived shutdown()"
    ray_tpu_torch.init(address=c.gcs_address, log_to_driver=False)
    try:
        assert ray_tpu_torch.get(ray_tpu_torch.remote(tasks.speak).remote(
            "thud-opt-out")) == 1
        _wait(lambda: any(
            "thud-opt-out" in r["line"]
            for p in (state.list_logs().get("procs") or {})
            for r in state.get_log(proc=p, tail=200).get("lines") or []),
            20, "the opted-out line in the store")
        time.sleep(0.5)
        cap = capsys.readouterr()
        assert "thud-opt-out" not in cap.out + cap.err
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(address=c.gcs_address)
