"""WorkerGroup + BackendExecutor: one spawned process per rank.

Port of ``ray_tpu/train/worker_group.py``. The JAX package runs each rank
as an actor of its own runtime and wires it for ``jax.distributed``
(``:39-41``); the reference's backend hook runs
``torch.distributed.init_process_group`` on every rank
(``train/torch/config.py:63``). The port spawns one process per rank
(``multiprocessing``'s spawn context: a fork after CUDA is up is unsafe),
and each rank joins a ``torch.distributed`` group over
``tcp://localhost:<port>`` (``parallel.process_group``), takes its card
(``rank % device_count``) or the CPU, opens its session and runs the
loop. The loop and its config reach the rank by plain ``pickle``: a loop
is a module-level function, its settings in the config.

- With ``use_gpu`` the driver builds the kernels (``_kernels.build()``)
  before it spawns, so each rank only loads the libraries.
- Reports come back over a ``multiprocessing`` queue. When a rank
  finishes it sends its stats: its telemetry (``StepTelemetry.summary``),
  the process group's collective and staging seconds, its kernel launch
  counts (the counters are per process) and its peak card memory.
- A rank that raises posts its traceback and exits non-zero; the driver
  then kills the others, which would otherwise wait in a collective. A
  rank that dies without a word is reported by its exit code. No rank is
  left running after ``shutdown``.
- The rendezvous port is drawn below the kernel's ephemeral range
  (``process_group.free_port``); if it was taken in the moment before
  rank 0 bound it, the group starts once more on a new one, and says so
  in a warning.
- ``execute``/``execute_async``/``healthy`` (``ray_tpu/train/
  worker_group.py:115-126``): ranks spawned at the first call stay up,
  each taking ``(fn, args)`` from its own queue and posting the result;
  what a rank keeps between calls lives in its session context
  (``session.get_context().objects``). A call that raises ends its rank
  as a failed loop does, and the calling process kills the others.
"""

from __future__ import annotations

import inspect
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from typing import Callable

from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.parallel.process_group import check_backend, free_port

_log = logging.getLogger(__name__)

# how long shutdown waits for a killed rank to be reaped
_JOIN_S = 30.0


def _wants_config(fn) -> bool:
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return True


def _rank_stats(pg) -> dict:
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from ray_tpu_torch.train import session

    t = session.telemetry()
    cuda = pg.device.type == "cuda"
    return {"rank": pg.rank, "device": str(pg.device),
            "device_name": torch.cuda.get_device_name(pg.device)
            if cuda else "cpu",
            "telemetry": t.summary() if t is not None else None,
            "process_group": dict(pg.stats),
            "launches": {"flash_fwd": flash_fwd.launches,
                         "flash_bwd": flash_bwd.launches},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(pg.device)
            if cuda else None}


def _rank_main(rank: int, world_size: int, port: int, backend: str,
               use_gpu: bool, fn: Callable, config: dict, queue,
               trial_dir: str, restore_checkpoint: str | None,
               run_name: str, env: dict) -> None:
    """The body of one rank process."""
    for k, v in env.items():
        os.environ[k] = str(v)
    from ray_tpu_torch.parallel.process_group import init_process_group
    from ray_tpu_torch.train import session

    pg = None
    try:
        pg = init_process_group(backend, rank, world_size, port,
                                use_gpu=use_gpu)
        ctx = session.TrainContext(
            rank=rank, world_size=world_size, local_rank=rank,
            trial_dir=trial_dir, experiment_name=run_name,
            restore_checkpoint=restore_checkpoint, device=str(pg.device),
            process_group=pg)
        session._init_session(ctx, queue)
        # trainer-config FLOPs declaration (the alternative to calling
        # session.set_flops_per_step() inside the loop)
        if config.get("flops_per_step"):
            session.set_flops_per_step(config["flops_per_step"],
                                       config.get("peak_flops"))
        fn(config) if _wants_config(fn) else fn()
        queue.put({"rank": rank, "done": True, "stats": _rank_stats(pg)})
    except BaseException as e:
        queue.put({"rank": rank,
                   "error": f"{type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()}"})
        raise
    finally:
        if pg is not None:
            pg.destroy()


def _execute_loop(config: dict) -> None:
    """The loop of a rank that stays up (``WorkerGroup.execute``): run each
    ``(call, fn, args, kwargs)`` from the rank's own queue and post the
    result; ``None`` ends it. A call that raises ends the rank
    (``_rank_main`` posts the traceback)."""
    from ray_tpu_torch.train import session

    rank = session.get_context().rank
    while True:
        item = config["calls"].get()
        if item is None:
            return
        call, fn, args, kwargs = item
        config["results"].put({"rank": rank, "call": call,
                               "result": fn(*args, **kwargs)})


def _ping() -> int:
    from ray_tpu_torch.train import session

    return session.get_context().rank


class RankCall:
    """One rank's part of an ``execute_async`` call: ``result(timeout)``
    waits for it (``TimeoutError`` after ``timeout`` seconds; a
    ``RuntimeError`` with the traceback if a rank failed)."""

    def __init__(self, group, call: int, rank: int):
        self.group, self.call, self.rank = group, call, rank

    def result(self, timeout: float | None = None):
        return self.group._result(self.call, self.rank, timeout)


class WorkerGroup:
    """The rank processes of one run, per ``ScalingConfig``: a loop on
    every rank (``start``), or ranks that stay up and run the functions
    given to ``execute`` (module docstring)."""

    def __init__(self, scaling: ScalingConfig, env: dict | None = None):
        self.scaling = scaling
        self.backend = scaling.resolved_backend()
        # refuse before any rank starts (NCCL: a card per rank)
        check_backend(self.backend, scaling.num_workers, scaling.use_gpu)
        # every rank is on this host: the rendezvous is tcp://localhost and
        # the backends' sockets use the loopback interface
        self.env = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo",
                    **(env or {})}
        self._ctx = mp.get_context("spawn")
        self.queue = self._ctx.Queue()
        self.processes: list = []
        # execute: each rank's call queue, the next call's number, results
        # taken off the queue before they were asked for, and the failure
        # that ended the group
        self._calls: list | None = None
        self._next_call = 0
        self._results: dict = {}
        self._error: str | None = None

    def start(self, fn: Callable, configs: list, trial_dir: str,
              restore_checkpoint: str | None = None,
              run_name: str = "") -> None:
        """Spawn one process per rank, rank ``r`` running ``fn`` on
        ``configs[r]``."""
        if self.scaling.use_gpu:
            from ray_tpu_torch import _kernels

            _kernels.build()
        port = free_port()
        n = self.scaling.num_workers
        self.processes = [self._ctx.Process(
            target=_rank_main, name=f"rank{rank}", daemon=True,
            args=(rank, n, port, self.backend, self.scaling.use_gpu, fn,
                  configs[rank], self.queue, trial_dir, restore_checkpoint,
                  run_name, self.env))
            for rank in range(n)]
        for p in self.processes:
            p.start()

    def execute_async(self, fn: Callable, *args, **kwargs) -> list:
        """Run ``fn(*args, **kwargs)`` on every rank; one ``RankCall`` a
        rank, in rank order. The first call spawns the ranks, which stay
        up until ``shutdown``. ``fn`` and its arguments reach the ranks by
        plain ``pickle`` (a module-level function or a ``partial`` of
        one)."""
        if self._error is not None:
            raise RuntimeError(self._error)
        if not self.processes:
            self._calls = [self._ctx.Queue()
                           for _ in range(self.scaling.num_workers)]
            self.start(_execute_loop, [{"calls": q, "results": self.queue}
                                       for q in self._calls], trial_dir="")
        elif self._calls is None:
            raise RuntimeError("this group runs a loop (start); execute "
                               "needs a WorkerGroup of its own")
        call = self._next_call
        self._next_call += 1
        for q in self._calls:
            q.put((call, fn, args, kwargs))
        return [RankCall(self, call, r) for r in range(len(self._calls))]

    def execute(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)``'s result on every rank, in rank order."""
        return [c.result() for c in self.execute_async(fn, *args, **kwargs)]

    def healthy(self) -> bool:
        """Whether every rank answers a ping within 10 s (False once a rank
        has failed or the group was shut down)."""
        try:
            for c in self.execute_async(_ping):
                c.result(timeout=10.0)
            return True
        except (RuntimeError, TimeoutError):
            return False

    def _fail(self, error: str):
        self._error = error
        self.shutdown()
        raise RuntimeError(error)

    def _take_report(self, rep: dict) -> None:
        if "error" in rep:
            self._fail(f"rank {rep['rank']} failed: {rep['error']}")
        if "call" in rep:
            self._results[(rep["call"], rep["rank"])] = rep["result"]

    def _result(self, call: int, rank: int, timeout: float | None):
        end = None if timeout is None else time.monotonic() + timeout
        while (call, rank) not in self._results:
            if self._error is not None:
                raise RuntimeError(self._error)
            try:
                self._take_report(self.queue.get(timeout=0.1))
                continue
            except queue_mod.Empty:
                pass
            lost = [(r, p.exitcode) for r, p in enumerate(self.processes)
                    if p.exitcode is not None]
            if lost:
                # a rank flushes its last puts (its traceback) before it
                # exits: read them before blaming the exit code
                try:
                    while True:
                        self._take_report(self.queue.get(timeout=0.5))
                except queue_mod.Empty:
                    pass
                self._fail(f"rank {lost[0][0]} exited with code "
                           f"{lost[0][1]}")
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"rank {rank} did not answer call {call} "
                                   f"within {timeout} s")
        return self._results.pop((call, rank))

    def shutdown(self) -> None:
        """Kill every rank still running and reap them all."""
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join(_JOIN_S)
        self.queue.close()
        self.queue.cancel_join_thread()
        for q in self._calls or ():
            q.close()
            q.cancel_join_thread()
        if self._error is None:
            self._error = "the worker group was shut down"


class BackendExecutor:
    """Launches the training loop on every rank and streams its reports
    (reference: ``BackendExecutor.start_training:424``)."""

    def __init__(self, scaling: ScalingConfig, env: dict | None = None):
        self.scaling = scaling
        self.env = env
        self.group = WorkerGroup(scaling, env=env)
        self.stats: dict[int, dict] = {}
        self._done: set[int] = set()
        self._failed = False
        self._retried_port = False
        self._args = None

    def start_training(self, train_fn: Callable, configs: list,
                       trial_dir: str,
                       restore_checkpoint: str | None = None,
                       run_name: str = "") -> None:
        self._args = (train_fn, configs, trial_dir, restore_checkpoint,
                      run_name)
        self.group.start(*self._args)

    def _drain(self, wait_s: float) -> list:
        out = []
        try:
            out.append(self.group.queue.get(timeout=wait_s))
            while True:
                out.append(self.group.queue.get_nowait())
        except queue_mod.Empty:
            pass
        return out

    def _take(self, reports: list, out: list) -> None:
        for rep in reports:
            if rep.get("done"):
                self._done.add(rep["rank"])
                self.stats[rep["rank"]] = rep["stats"]
            else:
                out.append(rep)

    def _settle(self, out: list, quiet_s: float = 0.2,
                limit_s: float = 2.0) -> None:
        """Take the reports still arriving until none has come for
        ``quiet_s`` (at most ``limit_s``)."""
        end = time.monotonic() + limit_s
        while time.monotonic() < end:
            got = self._drain(quiet_s)
            if not got:
                return
            self._take(got, out)

    def poll_reports(self, wait_s: float = 0.05) -> tuple[list, bool]:
        """Reports that arrived (metrics reports, and ``{"rank",
        "error"}`` for a failed rank), and whether the run is over: every
        rank done, or one failed (the others are then killed)."""
        out = []
        self._take(self._drain(wait_s), out)
        errors = [rep["error"] for rep in out if "error" in rep]
        if errors and not self._retried_port and not self._done and any(
                "EADDRINUSE" in e or "ddress already in use" in e
                for e in errors):
            # the port was taken before rank 0 bound it: once more
            self._retried_port = True
            _log.warning("rank 0 could not bind its rendezvous port; "
                         "starting the group once more on a new one")
            self.group.shutdown()
            self.group = WorkerGroup(self.scaling, env=self.env)
            self.group.start(*self._args)
            return [], False
        procs = self.group.processes
        lost = [r for r, p in enumerate(procs)
                if p.exitcode is not None and r not in self._done]
        if lost and not errors:
            # a rank flushes its last puts before it exits: drain again
            self._take(self._drain(0.5), out)
            errors = [rep["error"] for rep in out if "error" in rep]
            lost = [r for r in lost if r not in self._done]
            if not errors and lost:
                out += [{"rank": r, "error": f"rank {r} exited with code "
                         f"{procs[r].exitcode} without reporting"}
                        for r in lost]
                errors = [out[-1]["error"]]
        if errors:
            # the other ranks' last puts (a report naming a checkpoint,
            # made just before they failed too) may still be on their way
            self._settle(out)
            self._failed = True
            self.group.shutdown()
        return out, self._failed or \
            len(self._done) == self.scaling.num_workers

    def rank_stats(self) -> list:
        """Each finished rank's stats, in rank order."""
        return [self.stats[r] for r in sorted(self.stats)]

    def shutdown(self) -> None:
        self.group.shutdown()
