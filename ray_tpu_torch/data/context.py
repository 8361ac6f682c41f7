"""Execution context and knobs of ``ray_tpu_torch.data``.

Port of ``ray_tpu/data/context.py`` (reference:
``python/ray/data/context.py``, ``use_push_based_shuffle`` at
``context.py:156-187``). One context a process, read at plan and
execution time.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import ClassVar


@dataclass
class DataContext:
    # Distributed two-stage shuffle (map partitions -> reduce concat) vs
    # the centralized gather shuffle. The push-based path keeps every
    # partition in the object store as its own task output, so no single
    # process materializes the whole dataset.
    use_push_based_shuffle: bool = False
    # default parallelism for shuffle reduce tasks (None = #input blocks)
    shuffle_partitions: int | None = None
    # target rows per block for sources that chunk data
    target_num_blocks: int = 8
    # Blocks larger than this are split after a map task (size-based
    # block splitting; reference: DataContext.target_max_block_size,
    # default 128 MiB — smaller here because blocks round-trip through a
    # per-node shm store sized for tests and single hosts).
    target_max_block_size: int = 32 << 20
    # Streaming-executor backpressure: cap on bytes resident across the
    # topology (queued + in-flight). None = execution_budget_fraction of
    # the object store capacity (reference budgets 25% of the store —
    # streaming_executor_state.py:39).
    execution_budget_bytes: int | None = None
    execution_budget_fraction: float = 0.25
    extra: dict = field(default_factory=dict)

    _lock: ClassVar[threading.Lock] = threading.Lock()
    _current: ClassVar["DataContext | None"] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = DataContext()
            return cls._current
