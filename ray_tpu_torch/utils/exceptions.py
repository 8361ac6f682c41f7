"""Error hierarchy.

A copy of ``ray_tpu/utils/exceptions.py``. Analog of the reference's
``python/ray/exceptions.py`` (RayError, RayTaskError, ActorDiedError,
ObjectLostError, OutOfMemoryError, GetTimeoutError, ...).
Task errors wrap the remote traceback so the driver sees the real failure site.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception. Re-raised at ``get()`` on the caller,
    carrying the remote traceback (reference: ``RayTaskError``)."""

    def __init__(self, function_name: str, cause: BaseException, tb: str | None = None):
        self.function_name = function_name
        self.cause = cause
        self.remote_traceback = tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(
            f"Task {function_name!r} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{self.remote_traceback}"
        )

    def __reduce__(self):
        # Exception's default reduce passes the formatted message as *args,
        # which does not match this __init__ — rebuild from fields (the
        # cause may itself be unpicklable; degrade to its repr).
        try:
            import pickle

            # round-trip: exceptions commonly fail at LOAD time (custom
            # __init__ signatures break the default args-based reduce)
            pickle.loads(pickle.dumps(self.cause))
            cause = self.cause
        except Exception:  # noqa: BLE001
            cause = RuntimeError(repr(self.cause))
        return (TaskError, (self.function_name, cause, self.remote_traceback))


class ActorError(RayTpuError):
    """Base for actor failures."""


class ActorDiedError(ActorError):
    """The actor process died (or was killed) before/while executing the call."""

    def __init__(self, actor_id=None, reason: str = "actor died",
                 restart_count: int = 0):
        self.actor_id = actor_id
        self.reason = reason
        self.restart_count = restart_count
        tail = (f" (restarted {restart_count}x)" if restart_count else "")
        super().__init__(f"Actor {actor_id} unavailable: {reason}{tail}")

    def __reduce__(self):
        return (ActorDiedError,
                (self.actor_id, self.reason, self.restart_count))


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting)."""


class NodeDiedError(RayTpuError):
    """The node hosting the work died (raylet process gone / heartbeat
    lost). Carries the node id and how many times the cluster supervisor
    has respawned raylets so far — a crashed peer must surface as this,
    never as a bare redial-deadline ``TimeoutError`` (reference:
    ``NodeDiedError`` / ``RayletDiedError``)."""

    def __init__(self, node_id=None, reason: str = "node died",
                 restart_count: int = 0):
        self.node_id = node_id
        self.reason = reason
        self.restart_count = restart_count
        tail = (f" (node respawned {restart_count}x)"
                if restart_count else "")
        super().__init__(f"Node {node_id} died: {reason}{tail}")

    def __reduce__(self):
        return (NodeDiedError,
                (self.node_id, self.reason, self.restart_count))


class ReplicaDiedError(ActorError):
    """A serve replica died while (or before) handling the request. The
    router raises this typed-fast for in-flight requests instead of
    letting them ride a transport redial window; carries the replica tag
    and the deployment's replacement count so callers can tell a one-off
    crash from a crash loop."""

    def __init__(self, replica_tag=None, deployment=None,
                 reason: str = "replica died", restart_count: int = 0):
        self.replica_tag = replica_tag
        self.deployment = deployment
        self.reason = reason
        self.restart_count = restart_count
        tail = (f" (deployment replaced {restart_count} replicas)"
                if restart_count else "")
        super().__init__(
            f"Replica {replica_tag} of {deployment!r} died: "
            f"{reason}{tail}")

    def __reduce__(self):
        return (ReplicaDiedError,
                (self.replica_tag, self.deployment, self.reason,
                 self.restart_count))


class ObjectLostError(RayTpuError):
    """Object value was lost from the store and could not be reconstructed."""

    def __init__(self, object_id=None, reason: str = "object lost"):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost: {reason}")


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage re-execution could not rebuild the object (retries exhausted)."""


class OwnerDiedError(ObjectLostError):
    """The object's owner process died; value unrecoverable."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get(ref, timeout=...)`` expired before the object was ready."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ``cancel()`` before or during execution."""

    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly
    (reference: ``WorkerCrashedError``)."""


class OutOfMemoryError(RayTpuError):
    """Raised when the memory monitor kills a task/worker under host-RAM
    pressure (reference: raylet worker-killing policies)."""


class ObjectStoreFullError(RayTpuError):
    """Object store is at capacity and eviction/spilling could not make room."""


class RuntimeEnvSetupError(RayTpuError):
    """Per-task/actor runtime environment failed to materialize."""


class PlacementGroupUnavailableError(RayTpuError):
    """Placement group bundles could not be reserved."""
