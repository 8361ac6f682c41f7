"""Rank loops of the port's harness tests (``tests/test_torch_harness.py``,
``tests/test_torch_imports.py``).

A rank process receives its loop by plain ``pickle``, so each loop is a
module-level function of a module that imports neither jax nor any
``ray_tpu`` module (the test files import both). Every loop runs with one
thread.
"""

import json
import os
import sys

import numpy as np
import torch


def _rank_file(name: str) -> str:
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    return os.path.join(ctx.trial_dir, f"{name}_rank{ctx.rank}.json")


def report_loop(config):
    """Three reports a rank; each rank writes the sum and the row count of
    its dataset shard, read in batches of 8."""
    torch.set_num_threads(1)
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    shard = config.get("train_shard")
    if shard is not None:
        ids = [b["id"] for b in shard.iter_batches(batch_size=8)]
        with open(_rank_file("shard"), "w") as f:
            json.dump({"total": int(sum(int(i.sum()) for i in ids)),
                       "rows": int(sum(len(i) for i in ids)),
                       "batch_rows": [len(i) for i in ids]}, f)
    for i in range(3):
        session.report({"loss": 1.0 / (i + 1), "rank": ctx.rank,
                        "world": ctx.world_size})


def flaky_loop(config):
    """First attempt: report a checkpoint of step 2, then fail. The retry
    resumes from that checkpoint and reports the step it found."""
    torch.set_num_threads(1)
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    restored = session.get_checkpoint_dir()
    if restored is None:
        ckpt = os.path.join(ctx.trial_dir, "ckpt_2")
        os.makedirs(ckpt, exist_ok=True)
        with open(os.path.join(ckpt, "step"), "w") as f:
            f.write("2")
        session.report({"step": 2}, checkpoint_dir=ckpt)
        raise RuntimeError("transient-failure")
    with open(os.path.join(restored, "step")) as f:
        session.report({"ok": 1, "resumed_from": int(f.read())})


def error_loop(config):
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never
    enters, until the driver kills it."""
    torch.set_num_threads(1)
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    if ctx.rank == 1:
        raise ValueError("broken loop")
    ctx.process_group.all_reduce(torch.zeros(1))
    ctx.process_group.all_reduce(torch.zeros(1))


def modules_loop(config):
    """Report what this rank process has loaded of jax and ray_tpu."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.trainer import Trainer  # noqa: F401

    session.report({
        "jax": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith("jax.")),
        "ray_tpu": sorted(m for m in sys.modules
                          if m == "ray_tpu" or m.startswith("ray_tpu.")),
        "cuda_initialized": torch.cuda.is_initialized()})


def collectives_loop(config):
    """The process group's collectives on this rank's values; results to
    a file of the rank."""
    torch.set_num_threads(1)
    from ray_tpu_torch.parallel import process_group
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    pg, r = ctx.process_group, ctx.rank
    out = {}
    out["sum"] = pg.all_reduce(torch.tensor([1.0, 2.0]) * (r + 1)).tolist()
    out["mean"] = pg.all_reduce(torch.tensor([1.0, 2.0]) * (r + 1),
                                op="mean").tolist()
    out["bf16_sum"] = pg.all_reduce(
        torch.full((3,), 0.5 * (r + 1), dtype=torch.bfloat16)).float().tolist()
    out["broadcast"] = pg.broadcast(torch.tensor([float(r)] * 2),
                                    src=1).tolist()
    out["gathered"] = pg.all_gather_object({"rank": r})
    # buckets of 64 bytes: leaves packed, split across buckets, and one
    # leaf larger than a bucket reduced by itself
    process_group.BUCKET_BYTES = config["bucket_bytes"]
    rng = np.random.default_rng(r)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in config["shapes"]]
    grads.append(torch.from_numpy(rng.standard_normal(7)).double())
    want = [g.clone() for g in grads]
    pg.all_reduce_grads(grads)
    out["grads"] = [g.tolist() for g in grads]
    out["mine"] = [g.tolist() for g in want]
    out["stats"] = pg.stats
    same = [("a", torch.ones(4)), ("b", torch.arange(3.0))]
    pg.check_same(same)
    try:
        pg.check_same([("a", torch.ones(4)),
                       ("b", torch.arange(3.0) + r)])
        out["differ_raised"] = None
    except RuntimeError as e:
        out["differ_raised"] = str(e)
    with open(_rank_file("collectives"), "w") as f:
        json.dump(out, f)


def train_loop(config):
    """``Trainer`` over this rank's process group from the shared numpy
    weights, ``len(batches)`` steps for each case of ``config["cases"]``
    (name -> global batches); each case's losses and final parameters go
    to ``<out>/<case>_rank<r>.npz``. The controls: a case named
    ``*skip_all_reduce*`` runs with the gradient all-reduce made a no-op,
    one named ``*mean_all_reduce*`` with the summed gradients divided by
    the world size (a mean in place of the sum)."""
    torch.set_num_threads(1)
    from ray_tpu_torch import convert
    from ray_tpu_torch.parallel.process_group import ProcessGroup
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import Trainer

    ctx = session.get_context()
    for case, batches in config["cases"].items():
        tr = Trainer(config["model_config"], config["train_config"],
                     device="cpu", process_group=ctx.process_group)
        params = convert.params_from_numpy(
            config["model_config"], config["params"], device="cpu")
        state = TrainState.create(params, tr.optimizer)
        real = ProcessGroup.all_reduce_grads

        def mean(self, grads):
            real(self, grads)
            for g in grads:
                g.div_(self.world_size)
        if "skip_all_reduce" in case:
            ProcessGroup.all_reduce_grads = lambda self, grads: None
        elif "mean_all_reduce" in case:
            ProcessGroup.all_reduce_grads = mean
        try:
            losses, norms = [], []
            for batch in batches:
                state, m = tr.train_step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        finally:
            ProcessGroup.all_reduce_grads = real
        flat = {"losses": np.array(losses), "grad_norms": np.array(norms)}
        stack = [("", state.params)]
        while stack:
            prefix, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((f"{prefix}{k}.", v))
                else:
                    flat[f"{prefix}{k}"] = v.detach().numpy()
        np.savez(os.path.join(config["out"], f"{case}_rank{ctx.rank}.npz"),
                 **flat)
        session.report({"case": case, "losses": losses})
