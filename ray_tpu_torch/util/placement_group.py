"""Placement group public API.

Reference analog: ``python/ray/util/placement_group.py``: bundles with
the PACK, SPREAD, STRICT_PACK and STRICT_SPREAD strategies, reserved in
two phases on the GCS (``GcsPlacementGroupManager``). A bundle may ask
for ``GPU``, as a task's ``num_gpus`` does. On the in-process runtime,
which has one node, a group is placed as soon as it is made.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ray_tpu_torch.runtime import core as _core
from ray_tpu_torch.utils.ids import PlacementGroupID


@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: list
    strategy: str

    def ready(self, timeout: float = 30.0) -> bool:
        rt = _core.get_runtime()
        if not hasattr(rt, "_gcs"):
            return True  # the in-process runtime: placed at once
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = rt._gcs.call("get_placement_group", pg_id=self.id.hex())
            if info and info["state"] == "CREATED":
                return True
            time.sleep(0.05)
        return False

    @property
    def bundle_specs(self) -> list:
        return list(self.bundles)


def placement_group(bundles: list[dict], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    rt = _core.get_runtime()
    pg_id = PlacementGroupID.from_random()
    if hasattr(rt, "_gcs"):
        rt._gcs.call("create_placement_group", pg_id=pg_id.hex(),
                     bundles=[dict(b) for b in bundles], strategy=strategy)
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy)


def remove_placement_group(pg: PlacementGroup):
    rt = _core.get_runtime()
    if hasattr(rt, "_gcs"):
        rt._gcs.call("remove_placement_group", pg_id=pg.id.hex())


def placement_group_table(pg: PlacementGroup | None = None) -> dict:
    rt = _core.get_runtime()
    if not hasattr(rt, "_gcs"):
        return {}
    if pg is not None:
        info = rt._gcs.call("get_placement_group", pg_id=pg.id.hex())
        return info or {}
    return {p["pg_id"]: p
            for p in rt._gcs.call("list_placement_groups")}


class PlacementGroupSchedulingStrategy:
    """Pass as ``scheduling_strategy=`` in task or actor options
    (reference: ``util/scheduling_strategies.py``)."""

    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = -1):
        self.placement_group = placement_group
        self.bundle_index = placement_group_bundle_index
