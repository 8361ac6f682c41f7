"""The port's step telemetry and session (``train/telemetry.py``,
``train/session.py``) against the JAX package's, on the CPU.

The same sequence of ``timeit`` / ``on_report`` / ``mark_gap`` calls under
one patched clock must give the same stamps (step, wall, stages, MFU) and
the same goodput buckets from ``StepTelemetry`` of both packages.
``detect_peak_flops`` reads the card's name from a patched CUDA query.
"""

import queue
import time

import pytest
import torch

from ray_tpu.train import telemetry as jtel
from ray_tpu_torch.train import session
from ray_tpu_torch.train import telemetry as ttel


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _drive(tel, clock, flops):
    """One fixed sequence of calls; returns the stamps."""
    stamps = []
    clock.advance(0.75)                        # init, before any activity
    with tel.timeit("data_wait"):
        clock.advance(0.5)
    clock.advance(2.0)                         # compile residual
    stamps.append(tel.on_report({"loss": 1.0}))
    tel.set_flops_per_step(flops, peak_flops=1e12)
    with tel.timeit("collective_sync"):
        clock.advance(0.25)
    with tel.timeit("checkpoint"):
        clock.advance(1.0)
    with tel.timeit("data_wait"):
        clock.advance(0.125)
    clock.advance(3.0)
    stamps.append(tel.on_report({"loss": 0.5}))
    clock.advance(10.0)                        # an out-of-band gap
    tel.mark_gap()
    with tel.timeit("compute"):
        clock.advance(1.5)
    clock.advance(0.5)
    stamps.append(tel.on_report())
    return stamps


def test_add_books_seconds_timed_elsewhere(monkeypatch):
    """``add`` (the process group's all-reduce, timed on the card) books
    into the step like ``timeit``; as the first activity it starts the
    step where its block began, so the stages still sum to the wall."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    tel = ttel.StepTelemetry(run="r", rank=0, world_size=2)
    clock.advance(3.0)
    tel.add("collective_sync", 2.0)
    clock.advance(1.0)
    stamp = tel.on_report()
    assert stamp["wall_s"] == 3.0
    assert stamp["stages"] == {"collective_sync": 2.0, "compile": 1.0}
    assert tel.goodput["init"] == 1.0 and tel.goodput["stall"] == 2.0
    with tel.timeit("data_wait"):
        clock.advance(0.5)
    tel.add("collective_sync", 0.25)
    clock.advance(1.0)
    stamp = tel.on_report()
    assert stamp["wall_s"] == 1.5
    assert stamp["stages"] == {"data_wait": 0.5, "collective_sync": 0.25,
                               "compute": 0.75}


@pytest.mark.parametrize("flops", [2e12, 7.5e11])
def test_step_telemetry_matches_jax(monkeypatch, flops):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    runs = {}
    for name, mod in (("jax", jtel), ("torch", ttel)):
        tel = mod.StepTelemetry("run-a", 0, world_size=2)
        runs[name] = (_drive(tel, clock, flops), dict(tel.goodput),
                      tel.history, tel.step)
        if name == "jax":
            tel.close()   # retires its watchdog token
    assert runs["torch"] == runs["jax"]
    stamps, goodput, _, steps = runs["torch"]
    assert steps == 3
    for s in stamps:
        assert sum(s["stages"].values()) == pytest.approx(s["wall_s"])
    assert stamps[0]["stages"] == {"data_wait": 0.5, "compile": 2.0}
    assert stamps[1]["mfu"] == pytest.approx(flops / 4.375 / 1e12)
    assert stamps[2]["wall_s"] == pytest.approx(2.0)   # the gap is skipped
    assert goodput["init"] == pytest.approx(0.75)
    assert goodput["stall"] == pytest.approx(0.5 + 0.25 + 0.125)


def test_summary_and_driver_buckets():
    tel = ttel.StepTelemetry("run-b", 3)
    tel.on_report()
    s = tel.summary()
    assert s["rank"] == 3 and s["steps"] == 1 and len(s["history"]) == 1
    assert set(s["goodput"]) == set(ttel.GOODPUT_BUCKETS)
    ttel.record_run_bucket("run-b", "restart", 1.5)
    ttel.record_run_bucket("run-b", "restart", 0.5)
    ttel.record_run_bucket("run-b", "restart", -1.0)   # ignored
    assert ttel.run_goodput("run-b")["restart"] == 2.0
    assert ttel.run_goodput("never-recorded")["restart"] == 0.0


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_detect_peak_flops_from_the_card_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert ttel.detect_peak_flops() == want
    assert ttel.peak_flops_of(name) == want


def test_detect_peak_flops_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttel.detect_peak_flops() is None


def test_session_outside_and_inside_a_rank(monkeypatch):
    """Outside a rank: default context, no-op timeit and report. Inside:
    report closes the telemetry step before the put, and the put carries
    rank, metrics and checkpoint."""
    monkeypatch.setattr(session, "_session", type(session._session)())
    assert session.get_context().rank == 0
    assert session.telemetry() is None
    with session.timeit("data_wait"):
        pass
    session.report({"x": 1})
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    q = queue.Queue()
    session._init_session(session.TrainContext(
        rank=1, world_size=2, experiment_name="run-c", trial_dir="/t"), q)
    assert session.get_context().get_world_rank() == 1
    session.set_flops_per_step(4e12, peak_flops=2e12)
    with session.timeit("data_wait"):
        clock.advance(1.0)
    clock.advance(1.0)
    session.report({"loss": 2.0}, checkpoint_dir="/t/ck")
    assert q.get_nowait() == {"rank": 1, "metrics": {"loss": 2.0},
                              "checkpoint": "/t/ck"}
    stamp = session.telemetry().history[0]
    assert stamp["wall_s"] == 2.0 and stamp["mfu"] == 1.0
    monkeypatch.setenv("RAY_TPU_RESTORE_CHECKPOINT", "/elsewhere")
    assert session.get_checkpoint_dir() == "/elsewhere"
