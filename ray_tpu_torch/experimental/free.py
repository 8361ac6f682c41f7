"""Explicit object release (reference: ``ray._private.internal_api.free``
exposed via ``ray.experimental``): drop every stored copy of the objects
and, on a cluster, their lineage, so memory is reclaimed at once and a
later ``get`` cannot reconstruct them (the in-process runtime's ``get``
then waits out its timeout; the cluster's raises ``ObjectLostError``)."""

from __future__ import annotations

from ray_tpu_torch.runtime.object_ref import ObjectRef


def free(refs):
    from ray_tpu_torch import api as _api

    if isinstance(refs, ObjectRef):
        refs = [refs]
    # lazy like every other entry point: attaches inside a cluster worker
    _api._runtime().free(list(refs))
