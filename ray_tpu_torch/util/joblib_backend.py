"""joblib parallel backend over ray_tpu_torch tasks.

Reference analog: ``python/ray/util/joblib/``: ``register_ray()`` lets
scikit-learn-style code run
``with joblib.parallel_backend("ray_tpu"): Parallel()(delayed(f)(x)...)``
and have each batch of work items execute as a task.

``joblib`` is imported where it is used (``register_ray`` and the
backend's class, ``RayTpuBackend``, made at first access), so this module
imports without it; without it they raise an ``ImportError`` that names
it. A batch reaches a cluster's workers by stdlib pickle, so its
functions are module-level ones there.
"""

from __future__ import annotations

import functools

import ray_tpu_torch

__all__ = ["RayTpuBackend", "register_ray"]


def _joblib_parallel():
    try:
        from joblib import parallel
    except ImportError as e:
        raise ImportError(
            "ray_tpu_torch.util.joblib_backend requires joblib, which is "
            "not installed") from e
    return parallel


def _run_batch(func):
    """A task's body: one joblib batch."""
    return func()


_run_batch_remote = ray_tpu_torch.remote(_run_batch)


class _Future:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout=None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)


@functools.cache
def _backend_class():
    parallel = _joblib_parallel()

    class RayTpuBackend(parallel.ParallelBackendBase):
        """Minimal joblib backend: batches run as tasks; results gather
        at retrieval (joblib drives the callbacks)."""

        supports_timeout = True
        uses_threads = False
        supports_sharedmem = False

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None or n_jobs < 0:
                return 8
            return n_jobs

        def apply_async(self, func, callback=None):
            ref = _run_batch_remote.remote(func)
            fut = _Future(ref)
            if callback is not None:
                # joblib wants the callback once the result is ready; the
                # object's future resolves it without a thread of its own
                ref.future().add_done_callback(lambda _f: callback(fut))
            return fut

        def configure(self, n_jobs=1, parallel=None, **kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

    RayTpuBackend.__module__ = __name__
    RayTpuBackend.__qualname__ = "RayTpuBackend"
    return RayTpuBackend


def __getattr__(name):
    if name == "RayTpuBackend":
        return _backend_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def register_ray():
    """Register the ``"ray_tpu"`` joblib backend (reference:
    ``ray.util.joblib.register_ray``)."""
    _joblib_parallel().register_parallel_backend("ray_tpu", _backend_class())
