"""Public API: init / remote / get / put / wait / kill / cancel / actors.

Port of ``ray_tpu/api.py`` on the in-process runtime (reference:
``python/ray/_private/worker.py`` ``init:1139``, ``get:2461``,
``put:2590``, ``wait:2653``, ``remote:3027``, plus
``remote_function.py`` and ``actor.py``):

- ``@remote`` on a function -> ``f.remote(*args)`` returns ObjectRef(s).
- ``@remote`` on a class -> ``Cls.remote(*args)`` returns an ActorHandle;
  ``handle.method.remote(...)`` returns ObjectRefs; calls on one handle with
  ``max_concurrency=1`` execute in submission order.
- ObjectRefs passed as top-level arguments are resolved to values before the
  task body runs.

The card is the ``GPU`` resource (JAX's ``TPU``), asked for with
``num_gpus=`` (JAX's ``num_tpus=``). ``init()`` starts the in-process
runtime; ``init(address=...)`` connects to a running cluster of the port's
own GCS and raylets (``cluster_utils.Cluster``), whose tasks and actors run
in worker processes. ``runtime_env=`` (``runtime_env.RuntimeEnv`` or a
plain dict, validated at submission) runs a task or actor in its
environment: in-process on the local runtime, in worker processes of its
own on a cluster. ``f.bind(*args)`` builds a lazy ``dag.DAGNode``.
Waiting for later slices: the Ray client (``ray_tpu://`` addresses,
``client/``) and ``timeline`` (the observability planes).
"""

from __future__ import annotations

import functools
from typing import Sequence

from ray_tpu_torch.runtime import core as _core
from ray_tpu_torch.runtime.object_ref import ObjectRef
from ray_tpu_torch.runtime.task_spec import (
    ResourceSet,
    SchedulingStrategy,
    TaskSpec,
    TaskType,
)
from ray_tpu_torch.utils.config import get_config, reset_config
from ray_tpu_torch.utils.ids import ActorID, TaskID


# ---------------------------------------------------------------------------
# init / shutdown
# ---------------------------------------------------------------------------

def init(
    *,
    address=None,
    resources: dict | None = None,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    system_config: dict | None = None,
    ignore_reinit_error: bool = True,
    namespace: str | None = None,
    log_to_driver: bool = True,
):
    """Start the runtime (reference: ``ray.init``, ``worker.py:1139``).

    In-process by default: the CUDA cards torch sees are registered as a
    ``GPU`` resource unless ``num_gpus`` says otherwise. Pass
    ``address=(host, port)`` (a GCS address, e.g.
    ``cluster_utils.Cluster().gcs_address``) or ``"host:port"`` to connect
    to a running cluster instead; there ``log_to_driver`` echoes the
    workers' captured output on this process's stdout/stderr."""
    if _core.is_initialized():
        if ignore_reinit_error:
            return _core.get_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice")
    if address is not None:
        if isinstance(address, str) and address.startswith("ray_tpu://"):
            raise NotImplementedError(
                f"init(address={address!r}): the Ray client (client/) is "
                "a later slice of the port; pass a GCS address "
                "'host:port' to connect as a driver")
        if isinstance(address, str):
            host, sep, port = address.rpartition(":")
            if not sep or not port.isdigit():
                raise ValueError(
                    f"address must be 'host:port' or a (host, port) tuple, "
                    f"got {address!r}")
            address = (host or "127.0.0.1", int(port))
        from ray_tpu_torch.runtime.driver import ClusterRuntime

        rt = ClusterRuntime(address, namespace=namespace,
                            log_to_driver=log_to_driver)
        _core.install_runtime(rt)
        return rt
    reset_config()
    config = get_config().apply_overrides(system_config)
    res = dict(resources or {})
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    if num_gpus is not None:
        res["GPU"] = float(num_gpus)
    else:
        res.setdefault("GPU", float(_autodetect_gpu_count()))
    return _core.init_runtime(config=config, resources=res,
                              namespace=namespace)


def _autodetect_gpu_count() -> int:
    """The CUDA cards torch sees (JAX counts its TPU devices).
    ``torch.cuda.device_count`` asks NVML or the driver and leaves
    torch's CUDA state uninitialized."""
    import torch

    return torch.cuda.device_count()


def shutdown():
    _core.shutdown_runtime()


def is_initialized() -> bool:
    return _core.is_initialized()


def _runtime() -> _core.Runtime:
    if not _core.is_initialized():
        import os

        gcs_host = os.environ.get("RAY_TPU_TORCH_GCS_HOST")
        if gcs_host:
            # inside a cluster worker: connect to this node's raylet
            # (nested task/actor submission from tasks)
            from ray_tpu_torch.runtime.driver import ClusterRuntime

            rt = ClusterRuntime(
                (gcs_host, int(os.environ["RAY_TPU_TORCH_GCS_PORT"])),
                raylet_address=(
                    os.environ["RAY_TPU_TORCH_RAYLET_HOST"],
                    int(os.environ["RAY_TPU_TORCH_RAYLET_PORT"])))
            _core.install_runtime(rt)
        else:
            init()
    return _core.get_runtime()


# ---------------------------------------------------------------------------
# Object API
# ---------------------------------------------------------------------------

def put(value) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    return _runtime().put(value)


def get(refs, timeout: float | None = None):
    rt = _runtime()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list elements must be ObjectRefs, got {type(r)}")
    return rt.get(list(refs), timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return _runtime().wait(list(refs), num_returns=num_returns, timeout=timeout)


def cancel(ref: ObjectRef, *, force: bool = False):
    _runtime().cancel(ref, force=force)


# ---------------------------------------------------------------------------
# Remote functions
# ---------------------------------------------------------------------------

class RemoteFunction:
    """Wrapper created by ``@remote`` (reference: ``remote_function.py``)."""

    def __init__(self, fn, options: dict):
        self._fn = fn
        self._options = options
        # submit-invariant fields parsed ONCE (options() returns a fresh
        # RemoteFunction, so these never change for this instance) — at
        # 10k submits/s the per-call ResourceSet/strategy/env re-parse
        # was a measurable slice of the owner's submit loop
        self._resources = ResourceSet.from_options(
            num_cpus=options.get("num_cpus"),
            num_gpus=options.get("num_gpus"),
            memory=options.get("memory"),
            resources=options.get("resources"),
        )
        self._strategy = _parse_strategy(options)
        self._runtime_env = _normalize_runtime_env(
            options.get("runtime_env"))
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )

    def options(self, **overrides) -> "RemoteFunction":
        bad = set(overrides) - _TASK_OPTION_KEYS
        if bad:
            raise ValueError(f"Invalid task options: {sorted(bad)}")
        merged = {**self._options, **overrides}
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        rt = _runtime()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        if not (isinstance(num_returns, int)
                or num_returns in ("streaming", "dynamic")):
            # reference: _private/ray_option_utils.py:251-253 accepts an
            # int or the literals "dynamic" / "streaming"
            raise ValueError(
                f'num_returns must be an int, "dynamic" or "streaming", '
                f"got {num_returns!r}")
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            task_type=TaskType.NORMAL_TASK,
            function=self._fn,
            function_name=self._fn.__qualname__,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources=self._resources,
            scheduling_strategy=self._strategy,
            max_retries=opts.get("max_retries", 0),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            runtime_env=self._runtime_env,
        )
        refs = rt.submit_task(spec)
        rt.note_return_owner(spec)
        if num_returns == 1 or not isinstance(num_returns, int):
            return refs[0]   # single ref, or the ObjectRefGenerator
        return refs

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: ``dag_node.py`` .bind)."""
        from ray_tpu_torch.dag import DAGNode

        return DAGNode(self._fn, args, kwargs, options=self._options)

    @property
    def underlying_function(self):
        return self._fn


def _parse_strategy(opts: dict) -> SchedulingStrategy:
    s = opts.get("scheduling_strategy")
    if s is None:
        return SchedulingStrategy()
    if isinstance(s, SchedulingStrategy):
        return s
    if s == "SPREAD":
        return SchedulingStrategy(kind="SPREAD")
    if s == "DEFAULT":
        return SchedulingStrategy()
    # PlacementGroupSchedulingStrategy (duck-typed: util.placement_group
    # imports this module)
    if hasattr(s, "placement_group"):
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=s.placement_group.id,
            bundle_index=getattr(s, "bundle_index", -1))
    raise ValueError(f"Unknown scheduling strategy: {s!r}")


# ---------------------------------------------------------------------------
# Actors
# ---------------------------------------------------------------------------

class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(self._method_name, args, kwargs)

    def options(self, **overrides):
        # per-call overrides (num_returns etc.)
        bad = set(overrides) - {"num_returns"}
        if bad:
            raise ValueError(f"Invalid actor-method options: {sorted(bad)}")
        handle = self._handle
        name = self._method_name

        class _Bound:
            def remote(self, *args, **kwargs):
                return handle._submit_method(name, args, kwargs, overrides)

        return _Bound()

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use .remote()."
        )


class ActorHandle:
    """Client-side handle to an actor (reference: ``actor.py`` ActorHandle).
    Pickles by actor id, so handles can be passed to other tasks."""

    def __init__(self, actor_id: ActorID, class_name: str):
        self._actor_id = actor_id
        self._class_name = class_name

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        # cache on the instance: `a.m.remote()` in a tight loop must not
        # allocate a fresh ActorMethod per call (__getattr__ only fires
        # on misses, so the cached attribute short-circuits next time)
        method = ActorMethod(self, name)
        object.__setattr__(self, name, method)
        return method

    def _submit_method(self, method_name, args, kwargs, overrides=None):
        rt = _runtime()
        opts = overrides or {}
        num_returns = opts.get("num_returns", 1)
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            task_type=TaskType.ACTOR_TASK,
            function=None,
            function_name=f"{self._class_name}.{method_name}",
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            actor_id=self._actor_id,
            actor_method_name=method_name,
        )
        refs = rt.submit_task(spec)
        rt.note_return_owner(spec)
        if num_returns == 1 or not isinstance(num_returns, int):
            return refs[0]   # single ref, or the ObjectRefGenerator
        return refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"


class ActorClass:
    """Created by ``@remote`` on a class (reference: ``actor.py`` ActorClass,
    ``ActorClass.remote:524``)."""

    def __init__(self, cls, options: dict):
        self._cls = cls
        self._options = options
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()."
        )

    def options(self, **overrides) -> "ActorClass":
        bad = set(overrides) - _ACTOR_OPTION_KEYS
        if bad:
            raise ValueError(f"Invalid actor options: {sorted(bad)}")
        return ActorClass(self._cls, {**self._options, **overrides})

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = _runtime()
        opts = self._options
        max_concurrency = opts.get("max_concurrency")
        if max_concurrency is None:
            # reference default: async actors (any ``async def`` method)
            # get high concurrency (calls interleave at awaits); threaded
            # actors stay strictly serial
            import inspect

            is_async = any(
                inspect.iscoroutinefunction(getattr(self._cls, n, None))
                for n in dir(self._cls))
            max_concurrency = 1000 if is_async else 1
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            task_type=TaskType.ACTOR_CREATION_TASK,
            function=self._cls,
            function_name=f"{self._cls.__name__}.__init__",
            args=args,
            kwargs=kwargs,
            num_returns=1,
            resources=ResourceSet.from_options(
                num_cpus=opts.get("num_cpus"),
                num_gpus=opts.get("num_gpus"),
                memory=opts.get("memory"),
                resources=opts.get("resources"),
            ),
            scheduling_strategy=_parse_strategy(opts),
            max_concurrency=max_concurrency,
            max_restarts=opts.get("max_restarts", 0),
            runtime_env=_normalize_runtime_env(opts.get("runtime_env")),
        )
        lifetime = opts.get("lifetime")
        if lifetime not in (None, "detached", "non_detached"):
            raise ValueError(
                f"lifetime must be None, 'detached' or 'non_detached', "
                f"got {lifetime!r}")
        actor_id = rt.create_actor(
            spec, name=opts.get("name"), namespace=opts.get("namespace"),
            lifetime=None if lifetime == "non_detached" else lifetime)
        return ActorHandle(actor_id, self._cls.__name__)


def kill(handle: ActorHandle, *, no_restart: bool = True):
    if not isinstance(handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    _runtime().kill_actor(handle.actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    """Look up a named actor (reference: ``worker.py:2784`` — scoped to
    the caller's namespace unless one is given explicitly)."""
    rt = _runtime()
    actor_id = rt.get_actor(name, namespace)
    state = rt.actor_state(actor_id)
    cls_name = state.creation_spec.function.__name__ if state else "Actor"
    return ActorHandle(actor_id, cls_name)


# ---------------------------------------------------------------------------
# @remote decorator
# ---------------------------------------------------------------------------

# ``lifetime``: owner-scoped actor lifetime (reference: actor.py:524 +
# gcs_actor_manager.cc:632). On a cluster an actor dies when its owning
# client disconnects or misses heartbeats, and ``lifetime="detached"`` opts
# it out; in the in-process runtime the owner is this process, so every
# actor dies with it either way.
# an actor takes a scheduling strategy too (JAX's refuses one), so a
# PlacementGroupSchedulingStrategy places it on its bundle's node
_ACTOR_OPTION_KEYS = {
    "name", "namespace", "max_concurrency", "max_restarts", "num_cpus",
    "num_gpus", "memory", "resources", "lifetime", "runtime_env",
    "scheduling_strategy",
}
_TASK_OPTION_KEYS = {
    "num_returns", "num_cpus", "num_gpus", "memory", "resources",
    "max_retries", "retry_exceptions", "scheduling_strategy", "runtime_env",
}


def _normalize_runtime_env(env):
    """Accept RuntimeEnv or plain dict; validate dicts through RuntimeEnv
    so unknown or malformed fields fail at submission, not on the
    worker."""
    if env is None:
        return None
    from ray_tpu_torch.runtime_env import RuntimeEnv

    if isinstance(env, RuntimeEnv):
        return env.to_dict()
    return RuntimeEnv(**env).to_dict()


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=2, ...)`` on functions and classes."""

    def decorate(target):
        if isinstance(target, type):
            bad = set(kwargs) - _ACTOR_OPTION_KEYS
            if bad:
                raise ValueError(f"Invalid actor options: {sorted(bad)}")
            return ActorClass(target, dict(kwargs))
        if callable(target):
            bad = set(kwargs) - _TASK_OPTION_KEYS
            if bad:
                raise ValueError(f"Invalid task options: {sorted(bad)}")
            return RemoteFunction(target, dict(kwargs))
        raise TypeError(f"@remote target must be a function or class: {target}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return decorate(args[0])
    if args:
        raise TypeError("@remote accepts only keyword options")
    return decorate


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def cluster_resources() -> dict:
    return _runtime().cluster_resources()


def available_resources() -> dict:
    return _runtime().available_resources_snapshot()
