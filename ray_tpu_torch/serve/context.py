"""Replica context: which deployment/replica the current code runs in.

Port of ``ray_tpu/serve/context.py`` (reference analog:
``serve.get_replica_context()``, ``serve/context.py``'s ReplicaContext).
A host of deployment bodies sets the context on its own thread before it
constructs the body, so engine code (``serve/llm.py``) can tag itself
with the deployment name and a stable replica tag. Thread-local: several
replicas may share one process, each constructing its body on its own
thread. A Serve replica (``serve/controller.py`` ``_Replica``) sets it
before it constructs its body."""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class ReplicaContext:
    deployment: str
    replica_tag: str


_local = threading.local()


def set_replica_context(deployment: str | None,
                        replica_tag: str | None) -> None:
    """Install (or clear, with Nones) the calling thread's context."""
    if deployment is None or replica_tag is None:
        _local.ctx = None
    else:
        _local.ctx = ReplicaContext(deployment=str(deployment),
                                    replica_tag=str(replica_tag))


def get_replica_context() -> ReplicaContext | None:
    return getattr(_local, "ctx", None)
