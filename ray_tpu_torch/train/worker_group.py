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
- The rendezvous port is picked by binding port 0; if it was taken in the
  moment before rank 0 bound it, the group starts once more on a new one.
"""

from __future__ import annotations

import inspect
import multiprocessing as mp
import os
import queue as queue_mod
import traceback
from typing import Callable

from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.parallel.process_group import check_backend, free_port

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


class WorkerGroup:
    """The rank processes of one run, per ``ScalingConfig``."""

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

    def shutdown(self) -> None:
        """Kill every rank still running and reap them all."""
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join(_JOIN_S)
        self.queue.close()
        self.queue.cancel_join_thread()


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
            self._failed = True
            self.group.shutdown()
        return out, self._failed or \
            len(self._done) == self.scaling.num_workers

    def rank_stats(self) -> list:
        """Each finished rank's stats, in rank order."""
        return [self.stats[r] for r in sorted(self.stats)]

    def shutdown(self) -> None:
        self.group.shutdown()
