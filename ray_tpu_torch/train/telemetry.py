"""Training telemetry: step-time decomposition, MFU, goodput buckets.

Port of ``ray_tpu/train/telemetry.py``: ``StepTelemetry`` (``:96``) keeps
the same step clock, buckets and goodput accounting, in this process.
The JAX package also sends each step out as metric series, trace spans,
a progress annex and a watchdog token through its host observability
planes; the port's metrics plane does not carry them yet (their emission
comes with the tracing plane), so a rank's telemetry stays in its
``StepTelemetry`` (``history``, ``goodput``), which the harness sends back
to the driver when the rank finishes.

One :class:`StepTelemetry` lives per rank session (created by
``session._init_session``). The contract with the training loop:

- ``session.timeit("data_wait")`` / ``"collective_sync"`` /
  ``"checkpoint"`` / ``"compute"`` context managers accumulate measured
  wall clock into the CURRENT step's buckets; ``StepTelemetry.add``
  books seconds timed elsewhere (``session.report`` books the process
  group's gradient all-reduces, timed on the card, into
  ``collective_sync``).
- ``session.report(...)`` closes the step: step wall = time since the
  previous report (or since the first instrumented activity, for step
  1). Whatever the explicit buckets did not cover is the residual,
  attributed to ``compile`` on the first step and ``compute`` afterwards,
  so the decomposition sums to the observed step wall by construction.

Goodput buckets (cumulative, per rank):

- ``init``       session start -> first instrumented activity
- ``compile``    first-step residual
- ``productive`` per-step compute
- ``checkpoint`` save/restore wall inside steps
- ``stall``      data_wait + collective_sync
- ``restart``    elastic reform / trainer retry gaps (driver-recorded
                 via :func:`record_run_bucket`)

goodput_fraction = productive / total.
"""

from __future__ import annotations

import contextlib
import threading
import time

GOODPUT_BUCKETS = ("init", "compile", "productive", "checkpoint",
                   "stall", "restart")
STEP_STAGES = ("data_wait", "compute", "collective_sync", "checkpoint",
               "compile")
# step stage -> goodput bucket
_STAGE_TO_BUCKET = {"data_wait": "stall", "collective_sync": "stall",
                    "compute": "productive", "checkpoint": "checkpoint",
                    "compile": "compile"}

# dense bf16 FLOP/s of a card, by a part of its CUDA device name (NVIDIA's
# data sheets, without sparsity): the one table of card peaks in the repo
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12, "H100 PCIe": 756e12}


def peak_flops_of(device_name: str) -> float | None:
    """The bf16 peak of the card called ``device_name``, if the table
    knows it."""
    for key, flops in PEAK_BF16_FLOPS.items():
        if key in device_name:
            return flops
    return None


def detect_peak_flops() -> float | None:
    """Per-card peak FLOP/s from this process's CUDA card name, if the
    table knows it. None without a card or for another card: callers
    declare a peak for MFU there."""
    import torch

    if not torch.cuda.is_available():
        return None
    return peak_flops_of(torch.cuda.get_device_name())


class StepTelemetry:
    """Per-rank step clock: bucket accumulation, residual attribution,
    MFU and goodput counters."""

    def __init__(self, run: str, rank: int, *, world_size: int = 1,
                 flops_per_step: float | None = None,
                 peak_flops: float | None = None,
                 history_cap: int = 4096):
        self.run = run or "default"
        self.rank = int(rank)
        self.world_size = world_size
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.step = 0
        self.history: list[dict] = []
        self._history_cap = history_cap
        self._created = time.monotonic()
        self._step_start: float | None = None
        self._buckets: dict[str, float] = {}
        self.goodput: dict[str, float] = {b: 0.0 for b in GOODPUT_BUCKETS}
        self._lock = threading.Lock()

    # -- declaration ---------------------------------------------------

    def set_flops_per_step(self, flops: float,
                           peak_flops: float | None = None) -> None:
        self.flops_per_step = float(flops)
        if peak_flops is not None:
            self.peak_flops = float(peak_flops)

    # -- bucket accumulation -------------------------------------------

    @contextlib.contextmanager
    def timeit(self, bucket: str):
        """Accumulate the block's wall clock into ``bucket`` for the
        current step. First use also marks the step start (pre-step
        time becomes the ``init`` goodput bucket)."""
        self._ensure_step_start()
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(bucket, time.monotonic() - t0)

    def add(self, bucket: str, seconds: float) -> None:
        """Accumulate ``seconds`` timed elsewhere (a device timer's) into
        ``bucket`` for the current step: a block that ended now, so a
        first step starts no later than it began."""
        self._ensure_step_start(time.monotonic() - seconds)
        with self._lock:
            self._buckets[bucket] = self._buckets.get(bucket, 0.0) + seconds

    def mark_gap(self) -> None:
        """Restart the step clock at 'now', discarding the wall clock
        since the last report: for out-of-band gaps (elastic reform,
        retry pauses) already accounted to a bucket via
        :func:`record_run_bucket`, which must not leak into the next
        step's residual."""
        if self._step_start is not None:
            self._step_start = time.monotonic()

    def _ensure_step_start(self, now: float | None = None) -> float:
        if self._step_start is None:
            now = time.monotonic() if now is None else now
            self._step_start = now
            self.goodput["init"] += now - self._created
        return self._step_start

    # -- step close (called from session.report) ----------------------

    def on_report(self, metrics: dict | None = None) -> dict:
        """Close the current step; returns the stamp dict
        ``{step, wall_s, stages, mfu}``. ``stages`` sums to ``wall_s``
        exactly (residual attribution)."""
        start = self._ensure_step_start()
        now = time.monotonic()
        wall = max(now - start, 0.0)
        with self._lock:
            stages = dict(self._buckets)
            self._buckets = {}
        explicit = sum(stages.values())
        residual = max(wall - explicit, 0.0)
        sink = "compile" if self.step == 0 else "compute"
        stages[sink] = stages.get(sink, 0.0) + residual
        self.step += 1
        mfu = None
        if self.flops_per_step and self.peak_flops and wall > 0:
            mfu = self.flops_per_step / wall / self.peak_flops
        stamp = {"step": self.step, "wall_s": wall, "stages": stages,
                 "mfu": mfu}
        if len(self.history) < self._history_cap:
            self.history.append(stamp)
        for stage, dt in stages.items():
            self.goodput[_STAGE_TO_BUCKET.get(stage, "productive")] += dt
        self._step_start = now
        return stamp

    def summary(self) -> dict:
        """What the rank sends back to the driver: the step stamps and
        the goodput buckets."""
        return {"run": self.run, "rank": self.rank, "steps": self.step,
                "history": list(self.history), "goodput": dict(self.goodput),
                "flops_per_step": self.flops_per_step,
                "peak_flops": self.peak_flops}


# ---------------------------------------------------------------------
# driver-side bucket recording (restart badput: trainer retries and
# elastic reforms happen outside any rank session)

_driver_goodput: dict[tuple[str, str], dict[str, float]] = {}
_driver_lock = threading.Lock()


def record_run_bucket(run: str, bucket: str, seconds: float,
                      *, rank: str = "driver") -> None:
    """Attribute ``seconds`` of a run's wall clock to a goodput bucket
    from outside a rank session (DataParallelTrainer retry gaps,
    ElasticTrainer reforms)."""
    if seconds <= 0:
        return
    run = run or "default"
    with _driver_lock:
        cum = _driver_goodput.setdefault(
            (run, rank), {b: 0.0 for b in GOODPUT_BUCKETS})
        cum[bucket] = cum.get(bucket, 0.0) + seconds


def run_goodput(run: str, *, rank: str = "driver") -> dict[str, float]:
    """The buckets :func:`record_run_bucket` has recorded for ``run``."""
    with _driver_lock:
        return dict(_driver_goodput.get(
            (run or "default", rank), {b: 0.0 for b in GOODPUT_BUCKETS}))
