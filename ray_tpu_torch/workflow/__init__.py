"""Durable workflow execution (port of ``ray_tpu/workflow``; reference:
``python/ray/workflow/``).

``workflow.run(dag_node, workflow_id=...)`` executes a ``ray_tpu_torch.dag``
graph with a checkpoint a step: each node's result is saved under the
workflow's storage directory, keyed by a content-addressed step id, a
digest of the step's function (with what it captured) and its inputs
(static args and the ids of upstream steps). Editing the DAG therefore
invalidates exactly the steps whose inputs changed: an unrelated new
step never remaps another step's checkpoint, and a step whose upstream
chain changed runs again. ``resume`` re-runs the DAG, skipping every step
whose checkpoint exists (reference: ``workflow_state_from_storage.py``,
specialized to DAGs). Step functions reach a cluster's workers by stdlib
pickle: module-level functions, or ``functools.partial`` of them.
"""

from __future__ import annotations

import functools
import os
import pickle
import threading

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu

_rlu("workflow")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.dag import DAGNode  # noqa: E402

_STORAGE = os.path.join(os.path.expanduser("~"), "ray_tpu_torch_workflows")


def _arg_digest(h, value):
    import pickle as _pickle
    import re as _re

    # sets pickle in iteration order, which string-hash randomization
    # reshuffles per process — canonicalize so the SAME set always
    # digests the same and resume finds its checkpoints
    if isinstance(value, (set, frozenset)):
        h.update(b"set:")
        for item in sorted(value, key=repr):
            _arg_digest(h, item)
        return
    try:
        h.update(_pickle.dumps(value, protocol=5))
    except Exception:  # noqa: BLE001 - unpicklable static arg
        # repr() embeds memory addresses ("<X at 0x7f..>") which would
        # make the id differ every process and break resume — strip them
        # (the residual collision risk only affects unpicklable args,
        # which cluster execution couldn't ship anyway)
        h.update(_re.sub(r"0x[0-9a-fA-F]+", "0x", repr(value)).encode())


def _fn_digest(h, fn):
    """What makes a step function the step it is: its module and
    qualname, its bytecode and constants, and what it captured: its
    closure cells and its defaults (each by stdlib pickle where it
    pickles). A ``functools.partial`` is its function and its bound
    arguments."""
    if isinstance(fn, functools.partial):
        _fn_digest(h, fn.func)
        for a in fn.args:
            _arg_digest(h, a)
        for k in sorted(fn.keywords):
            h.update(k.encode())
            _arg_digest(h, fn.keywords[k])
        return
    h.update(getattr(fn, "__module__", "").encode())
    h.update(getattr(fn, "__qualname__", "step").encode())
    code = getattr(fn, "__code__", None)
    if code is not None:
        h.update(code.co_code)
        _arg_digest(h, code.co_consts)
    for cell in getattr(fn, "__closure__", None) or ():
        h.update(b"cell:")
        try:
            _arg_digest(h, cell.cell_contents)
        except ValueError:   # an empty cell
            h.update(b"empty")
    h.update(b"defaults:")
    _arg_digest(h, getattr(fn, "__defaults__", None))
    _arg_digest(h, getattr(fn, "__kwdefaults__", None))


def _step_ids(order: list[DAGNode]) -> dict[int, str]:
    """Content-addressed step ids: digest(the step function, static args,
    upstream step ids). Two identical sub-DAGs share an id, and so a
    checkpoint, which is sound for the deterministic steps workflows
    assume (and dedups repeated work on resume).

    JAX hashes the function with cloudpickle (by value: bytecode, closure
    cells, defaults, referenced globals) where cloudpickle imports, else
    its bytecode and constants alone (``ray_tpu/workflow/__init__.py:
    72-80``). The port never imports cloudpickle, and bytecode alone
    misses an edited default or captured value, so it digests those too
    (``_fn_digest``). Its ids are not JAX's strings."""
    import hashlib

    ids: dict[int, str] = {}
    for node in order:           # topo order: parents resolve first
        h = hashlib.sha256()
        _fn_digest(h, node._fn)
        for a in node._args:
            if isinstance(a, DAGNode):
                h.update(ids[id(a)].encode())
            else:
                _arg_digest(h, a)
        for k in sorted(node._kwargs):
            v = node._kwargs[k]
            h.update(k.encode())
            if isinstance(v, DAGNode):
                h.update(ids[id(v)].encode())
            else:
                _arg_digest(h, v)
        name = getattr(node._fn, "__name__", "step")
        ids[id(node)] = f"{name}-{h.hexdigest()[:16]}"
    return ids


def _run_step(node: DAGNode, args, kwargs):
    """One step with per-step workflow options (reference: step options
    ``max_retries``/``catch_exceptions`` in ``workflow/api.py``).

    - ``workflow_max_retries``: re-submit the step N extra times on error
    - ``workflow_catch_exceptions``: return (result, None) / (None, exc)
      instead of raising, so downstream steps can compensate (saga style)
    """
    import time as _time

    opts = dict(node._options or {})
    retries = int(opts.pop("workflow_max_retries", 0))
    catch = bool(opts.pop("workflow_catch_exceptions", False))
    task = ray_tpu_torch.remote(node._fn)
    if opts:
        task = task.options(**opts)
    last = None
    for attempt in range(retries + 1):
        try:
            value = ray_tpu_torch.get(task.remote(*args, **kwargs))
            return (value, None) if catch else value
        except Exception as e:  # noqa: BLE001
            # surface the USER's exception, not the runtime's TaskError
            # wrapper (reference: catch_exceptions hands back the cause)
            last = getattr(e, "cause", None) or e
            if attempt < retries:
                _time.sleep(0.05 * (attempt + 1))
    if catch:
        return (None, last)
    raise last


def run(dag: DAGNode, *, workflow_id: str,
        storage: str | None = None):
    """Execute with checkpointing; returns the final result (sync)."""
    root = os.path.join(storage or _STORAGE, workflow_id)
    os.makedirs(root, exist_ok=True)
    order = dag.topo_order()
    step_ids = _step_ids(order)
    results: dict[int, object] = {}
    final = None
    try:
        for node in order:
            path = os.path.join(root, step_ids[id(node)] + ".pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results[id(node)] = pickle.load(f)
                continue
            args = [results[id(a)] if isinstance(a, DAGNode) else a
                    for a in node._args]
            kwargs = {k: results[id(v)] if isinstance(v, DAGNode) else v
                      for k, v in node._kwargs.items()}
            value = _run_step(node, args, kwargs)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)  # atomic: a crash never leaves half a step
            results[id(node)] = value
        final = results[id(dag)]
    except Exception:
        _mark(root, "FAILED")
        raise
    # persist the workflow output for get_output() — atomically, like
    # step checkpoints (a crash mid-write must not fake a half-output)
    out_path = os.path.join(root, "_OUTPUT.pkl")
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(final, f)
    os.replace(tmp, out_path)
    _mark(root, "SUCCESS")
    # retire the events THIS workflow consumed so a later workflow
    # reusing the name blocks for a fresh signal (broadcast within one
    # run; no stale refire across runs)
    for node in order:
        ev = getattr(node._fn, "__wf_event_name__", None)
        if ev is not None:
            clear_event(ev)
    return final


def run_async(dag: DAGNode, *, workflow_id: str,
              storage: str | None = None):
    """Run the whole workflow inside a task; returns an ObjectRef
    (reference: ``workflow.run_async`` — ``workflow/api.py:174``).

    The storage path resolves on the DRIVER so the executing worker and
    the driver agree on it. On a multi-node cluster, pass a SHARED
    filesystem path (NFS/GCS fuse) — same requirement as the
    reference's workflow storage."""
    blob = (dag, workflow_id, storage or _STORAGE)
    return ray_tpu_torch.remote(_drive).remote(blob)


def _drive(payload):
    """The task of ``run_async`` (module level: stdlib pickle carries it
    to a cluster's workers)."""
    d, wid, st = payload
    return run(d, workflow_id=wid, storage=st)


def get_output(workflow_id: str, *, storage: str | None = None):
    """Result of a completed workflow (reference: workflow.get_output)."""
    root = os.path.join(storage or _STORAGE, workflow_id)
    path = os.path.join(root, "_OUTPUT.pkl")
    if not os.path.exists(path):
        raise ValueError(
            f"workflow {workflow_id!r} has no recorded output "
            f"(status={status(workflow_id, storage=storage)})")
    with open(path, "rb") as f:
        return pickle.load(f)


def resume(dag: DAGNode, *, workflow_id: str, storage: str | None = None):
    """Re-run, skipping checkpointed steps (crash recovery)."""
    return run(dag, workflow_id=workflow_id, storage=storage)


def status(workflow_id: str, *, storage: str | None = None) -> str:
    root = os.path.join(storage or _STORAGE, workflow_id)
    if not os.path.isdir(root):
        return "NOT_FOUND"
    if os.path.exists(os.path.join(root, "_STATUS_SUCCESS")):
        return "SUCCESS"
    if os.path.exists(os.path.join(root, "_STATUS_FAILED")):
        return "FAILED"
    return "RUNNING" if os.listdir(root) else "PENDING"


def metadata(workflow_id: str, *, storage: str | None = None) -> dict:
    """Steps completed + status (reference: workflow metadata API)."""
    root = os.path.join(storage or _STORAGE, workflow_id)
    steps = []
    if os.path.isdir(root):
        steps = sorted(f[:-4] for f in os.listdir(root)
                       if f.endswith(".pkl") and not f.startswith("_"))
    return {"workflow_id": workflow_id,
            "status": status(workflow_id, storage=storage),
            "steps_completed": steps}


# ---------------------------------------------------------------------------
# events (reference: workflow/http_event_provider.py). JAX keeps them in
# its internal KV (``ray_tpu.experimental``), so any process can signal
# them; the port's ``experimental`` is a later slice, so the same table
# lives here: the GCS's KV (namespace "internal_kv") on a cluster, a table
# of this process on the in-process runtime
# ---------------------------------------------------------------------------

_KV_NS = "internal_kv"
_local_kv: dict[str, bytes] = {}
_kv_lock = threading.Lock()


def _gcs():
    """The GCS client of the runtime this process is attached to, or
    None for the in-process runtime (as JAX's ``internal_kv._backend``)."""
    from ray_tpu_torch.runtime import core

    if not core.is_initialized():
        if not os.environ.get("RAY_TPU_TORCH_GCS_HOST"):
            return None
        ray_tpu_torch.api._runtime()   # a cluster worker attaches
    return getattr(core.get_runtime(), "_gcs", None)


def _kv_put(key: str, value: bytes) -> None:
    gcs = _gcs()
    if gcs is not None:
        gcs.call("kv_put", ns=_KV_NS, key=key, value=value, overwrite=True)
        return
    with _kv_lock:
        _local_kv[key] = value


def _kv_get(key: str):
    gcs = _gcs()
    if gcs is not None:
        return gcs.call("kv_get", ns=_KV_NS, key=key)
    with _kv_lock:
        return _local_kv.get(key)


def _kv_del(key: str) -> None:
    gcs = _gcs()
    if gcs is not None:
        gcs.call("kv_del", ns=_KV_NS, key=key)
        return
    with _kv_lock:
        _local_kv.pop(key, None)


def signal_event(name: str, payload=b"1") -> None:
    """Fire an event; a workflow blocked in wait_for_event resumes."""
    payload = payload if isinstance(payload, bytes) else \
        str(payload).encode()
    _kv_put(f"__wf_event_{name}", payload)


def clear_event(name: str) -> None:
    """Remove a fired event so its name can be reused without the new
    waiter seeing the stale payload."""
    _kv_del(f"__wf_event_{name}")


def _wait_event(name: str, poll_interval_s: float, timeout_s: float):
    """The step of ``event(name)``: the payload once the event fires."""
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        val = _kv_get(f"__wf_event_{name}")
        if val is not None:
            # BROADCAST semantics: the payload stays so every waiter
            # (concurrent workflows, parallel event nodes) resumes;
            # call clear_event() before reusing a name
            return val
        _time.sleep(poll_interval_s)
    raise TimeoutError(f"workflow event {name!r} never fired")


def event(name: str, *, poll_interval_s: float = 0.05,
          timeout_s: float = 60.0) -> DAGNode:
    """A DAG node that completes when the named event fires; its value is
    the event payload. Compose like any step:
        done = process.bind(workflow.event("upstream-ready"))
    """
    wait = functools.partial(_wait_event, name, poll_interval_s, timeout_s)
    wait.__name__ = wait.__qualname__ = f"event_{name}"
    wait.__wf_event_name__ = name
    return DAGNode(wait, (), {})


def list_all(*, storage: str | None = None) -> list[str]:
    base = storage or _STORAGE
    return sorted(os.listdir(base)) if os.path.isdir(base) else []


def delete(workflow_id: str, *, storage: str | None = None):
    import shutil

    shutil.rmtree(os.path.join(storage or _STORAGE, workflow_id),
                  ignore_errors=True)


def _mark(root: str, state: str):
    open(os.path.join(root, f"_STATUS_{state}"), "w").close()
