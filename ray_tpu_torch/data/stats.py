"""Per-operator execution statistics of the streaming executor.

Port of ``ray_tpu/data/stats.py`` (reference:
``python/ray/data/_internal/stats.py``, ``DatasetStats``): each
operator's wall and task times and its rows and bytes in and out
(``ds.stats()``), filled by the executor as bundles move; nothing is
computed unless read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class OperatorStats:
    name: str
    bundles_in: int = 0
    bundles_out: int = 0
    rows_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    tasks: int = 0
    # wall time of individual tasks (submit -> result observed)
    task_wall_s: list = field(default_factory=list)
    first_activity: float | None = None
    last_activity: float | None = None
    extra: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        if self.first_activity is None or self.last_activity is None:
            return 0.0
        return self.last_activity - self.first_activity

    def summary_line(self) -> str:
        parts = [f"{self.name}:",
                 f"in {self.bundles_in} bundles/{_fmt_bytes(self.bytes_in)}",
                 f"out {self.bundles_out}/{_fmt_bytes(self.bytes_out)}"
                 f" ({self.rows_out} rows)"]
        if self.tasks:
            parts.append(f"{self.tasks} tasks")
        if self.task_wall_s:
            ts = sorted(self.task_wall_s)
            mean = sum(ts) / len(ts)
            parts.append(
                f"task wall min/p50/mean/max "
                f"{ts[0] * 1e3:.0f}/{ts[len(ts) // 2] * 1e3:.0f}/"
                f"{mean * 1e3:.0f}/{ts[-1] * 1e3:.0f}ms")
        parts.append(f"total {self.wall_s:.2f}s")
        for k, v in self.extra.items():
            parts.append(f"{k}={v}")
        return " ".join(parts)


class DatasetStats:
    """Stats for one streaming execution: per-operator breakdown plus
    the end-to-end wall time."""

    def __init__(self):
        self.operators: list[OperatorStats] = []
        self.start_t = time.monotonic()
        self.end_t: float | None = None

    @property
    def wall_s(self) -> float:
        end = self.end_t if self.end_t is not None else time.monotonic()
        return end - self.start_t

    def summary(self) -> str:
        lines = [f"Dataset execution: {self.wall_s:.2f}s, "
                 f"{len(self.operators)} operators"]
        for i, op in enumerate(self.operators):
            lines.append(f"  Operator {i} {op.summary_line()}")
        return "\n".join(lines)

    # dict-style access by operator name, plus substring probes on the
    # rendered summary — ``stats()["Map"]["tasks"]`` and
    # ``"task wall" in stats()`` both work
    def __getitem__(self, name: str) -> dict:
        for op in self.operators:
            if op.name == name:
                return {
                    "bundles_in": op.bundles_in,
                    "bundles_out": op.bundles_out,
                    "rows_out": op.rows_out,
                    "bytes_in": op.bytes_in,
                    "bytes_out": op.bytes_out,
                    "tasks": op.tasks,
                    "wall_s": op.wall_s,
                }
        raise KeyError(name)

    def __contains__(self, item) -> bool:
        return item in self.summary()

    def __repr__(self):
        return self.summary()

    __str__ = __repr__


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}GB"
