"""Task/actor specifications — the unit of scheduling currency.

Port of ``ray_tpu/runtime/task_spec.py`` (reference: ``TaskSpecification``,
``src/ray/common/task/task_spec.h:244``): everything the scheduler and an
executing worker need, in one record. Resource demands are named float
resources: "CPU", "GPU" (the card; JAX's "TPU"), "memory", custom.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from ray_tpu_torch.utils.ids import (ActorID, ObjectID, PlacementGroupID,
                                     TaskID)


class TaskType(Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class ResourceSet:
    """Named float resource demand (reference: ``ResourceSet`` with fixed-point
    arithmetic; floats suffice here since demands come from user options)."""

    resources: dict[str, float] = field(default_factory=dict)

    @staticmethod
    def from_options(num_cpus=None, num_gpus=None, memory=None, resources=None):
        r: dict[str, float] = {}
        if num_cpus is not None:
            r["CPU"] = float(num_cpus)
        if num_gpus is not None:
            r["GPU"] = float(num_gpus)
        if memory is not None:
            r["memory"] = float(memory)
        if resources:
            r.update({k: float(v) for k, v in resources.items()})
        return ResourceSet(r)

    def fits_in(self, available: dict[str, float]) -> bool:
        return all(available.get(k, 0.0) >= v - 1e-9 for k, v in self.resources.items())

    def is_empty(self) -> bool:
        return not self.resources or all(v == 0 for v in self.resources.values())


@dataclass
class SchedulingStrategy:
    """Placement policy for one task (reference:
    ``util/scheduling_strategies.py``): DEFAULT (hybrid), SPREAD, node
    affinity, or placement-group bundle affinity. The in-process runtime
    has one node, so all place alike; the cluster runtime routes
    NODE_AFFINITY to ``node_id``'s raylet and PLACEMENT_GROUP to the node
    that holds the group's bundle."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id: Any = None
    placement_group_id: PlacementGroupID | None = None
    bundle_index: int = -1


@dataclass
class TaskSpec:
    task_id: TaskID
    task_type: TaskType
    function: Any  # callable or (serialized) function descriptor
    function_name: str
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    return_ids: list[ObjectID] = field(default_factory=list)
    resources: ResourceSet = field(default_factory=ResourceSet)
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    # actor fields
    actor_id: ActorID | None = None
    actor_method_name: str | None = None
    sequence_number: int = 0
    max_concurrency: int = 1
    max_restarts: int = 0
    # per-task/actor execution environment (runtime_env.RuntimeEnv dict)
    runtime_env: dict | None = None
