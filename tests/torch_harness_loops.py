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

        def mean(self, grads, group=None):
            real(self, grads, group)
            for g in grads:
                g.div_(self.world_size)
        if "skip_all_reduce" in case:
            ProcessGroup.all_reduce_grads = \
                lambda self, grads, group=None: None
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


def mlm_hook(model_cfg, params, batch):
    """BERT's masked-LM loss as the ``Trainer`` hook."""
    from ray_tpu_torch.models import bert

    return bert.mlm_loss(model_cfg, params, batch["tokens"],
                         batch["targets"],
                         attention_mask=batch["attention_mask"],
                         loss_mask=batch["loss_mask"])


def _controls(control: str, stack):
    """The faults of the cross-process step, patched in for a case:
    ``psum_backward`` (the rank-list ``psum``'s backward, an all-reduce,
    at the exits of the tp regions in place of ``g``'s identity: each
    process's replica of the sum carries the gradient on, so it is counted
    once a tp process), ``skip_reduce_scatter``
    (the fsdp gathers keep their piece of the gradient, unsummed over the
    data processes), ``reversed_ring`` (K/V shifted the wrong way
    round the ring), ``backward_to_next_stage`` (the 1F1B's gradients
    sent to stage s+1 in place of s-1), ``io_sum_skipped`` (the io
    parameters' gradients not summed over the stages' processes) and
    ``local_routing`` (each process routes its own tokens, with a
    capacity of its own token count); over an axis cut at the process
    boundary ``local_sum_skipped`` (a process's first chunk alone in
    the subgroup's all-reduce), ``boundary_reversed`` (the ring's K/V
    sent across each process boundary the wrong way, the moves inside a
    process as they are) and ``local_split_reversed`` (a process's block
    of a reduce-scatter handed to its places in reverse order)."""
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel import pipeline, ring_attention
    from ray_tpu_torch.train import spmd

    def patch(module, name, value):
        old = getattr(module, name)
        setattr(module, name, value)
        stack.callback(setattr, module, name, old)

    if control == "psum_backward":
        patch(spmd, "tp_exit", lambda xs, group: col.psum(xs, group=group))
    elif control == "skip_reduce_scatter":
        def gather(xs, gather_axis=0, tiled=True, group=None):
            if group is None:
                return col.all_gather(xs, gather_axis=gather_axis,
                                      tiled=tiled)
            return col.gather_from_group(xs, gather_axis=gather_axis,
                                         tiled=tiled, group=group)
        patch(spmd, "all_gather", gather)
    elif control == "reversed_ring":
        patch(ring_attention, "ring_shift", lambda xs, shift=1, group=None:
              col.ring_shift(xs, shift=-shift, group=group))
    elif control == "backward_to_next_stage":
        patch(pipeline, "backward_peer", lambda s, n: (s + 1) % n)
    elif control == "io_sum_skipped":
        patch(pipeline, "reduce_io_grads", lambda grads, group: None)
    elif control == "local_routing":
        patch(spmd.RankStep, "route_logits",
              lambda self, logits, mesh: (logits, 0))
    elif control == "local_sum_skipped":
        patch(col, "local_sum", lambda xs: xs[0])
    elif control == "boundary_reversed":
        def shift(xs, shift=1, group=None):
            n, k = col.axis_size(xs, group=group), len(xs)
            perm = [(i, (i + shift) % n) for i in range(n)]
            return col.ppermute(xs, [(d, s) if s // k != d // k else (s, d)
                                     for s, d in perm], group=group)
        patch(ring_attention, "ring_shift", shift)
    elif control == "local_split_reversed":
        split = col.local_split
        patch(col, "local_split",
              lambda x, k, dim, tiled: split(x, k, dim, tiled)[::-1])
    elif control:
        raise ValueError(f"unknown control {control!r}")


def placed_chunks(tree, mesh, prefix="") -> dict:
    """``{"<leaf>@<global place>": chunk}`` for every place of this
    process (the global place is the flat index in the global mesh's
    row-major order, JAX's ``mesh.devices.ravel()`` position)."""
    out = {}
    grid = tuple(mesh.shape.values())
    for name, st in tree.items():
        if isinstance(st, dict):
            out.update(placed_chunks(st, mesh, f"{prefix}{name}."))
            continue
        chunks = getattr(st, "chunks", None) or [st] * mesh.devices.size
        for i, c in enumerate(chunks):
            at = mesh.global_coords(np.unravel_index(i, mesh.devices.shape))
            out[f"{prefix}{name}@{int(np.ravel_multi_index(at, grid))}"] = \
                c.detach().numpy()
    return out


def cross_process_loop(config):
    """``Trainer`` over this rank's process group for each case of
    ``config["cases"]`` (name -> model config, train config kwargs, numpy
    weights, global batches, and optional ``hook``, ``control`` and
    ``ring_impl``), from the weights through
    ``convert.params_from_numpy``, placed by ``place_tree``. Each case's
    losses, gradient norms and every chunk of this process's places of
    the final parameters and moments go to ``<out>/<case>_rank<r>.npz``;
    with ``save``, a directory, the final state is saved there first
    (every process its own chunks)."""
    import contextlib
    from functools import partial

    torch.set_num_threads(1)
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.sharding import place_tree
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    ctx = session.get_context()
    for case, c in config["cases"].items():
        with contextlib.ExitStack() as stack:
            _controls(c.get("control"), stack)
            if c.get("ring_impl"):
                # the ring's body: "flash" runs the kernels' plain
                # versions on the CPU
                old = llama.ring_attention
                llama.ring_attention = partial(ring_attention,
                                               impl=c["ring_impl"])
                stack.callback(setattr, llama, "ring_attention", old)
            tr = Trainer(c["model_config"], TrainConfig(**c["train"]),
                         device="cpu", process_group=ctx.process_group,
                         loss_fn=mlm_hook if c.get("hook") else None)
            params = convert.params_from_numpy(c["model_config"],
                                               c["params"], device="cpu")
            state = place_tree(TrainState.create(params, tr.optimizer),
                               tr.state_shardings())
            losses, norms = [], []
            for batch in c["batches"]:
                state, m = tr.train_step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        if c.get("save"):
            from ray_tpu_torch.train.checkpoint import CheckpointManager

            CheckpointManager(c["save"], async_save=False).save(
                state.step, state)
        flat = {"losses": np.array(losses), "grad_norms": np.array(norms)}
        for tree in ("params", "mu", "nu"):
            node = state.params if tree == "params" else \
                state.opt_state[tree]
            flat.update(placed_chunks(node, tr.mesh, f"{tree}."))
        np.savez(os.path.join(config["out"], f"{case}_rank{ctx.rank}.npz"),
                 **flat)
        session.report({"case": case, "losses": losses})


def resume_loop(config):
    """``Trainer`` over this rank's process group on ``config["case"]``
    (as ``cross_process_loop``'s), resumed by ``DataParallelTrainer``'s
    retry. The first attempt takes one step, saves its checkpoint (every
    process its own chunks), waits for every process to have saved,
    reports it and fails; the retry restores it into the same layout and
    takes the remaining steps. Writes ``saved``, ``restored`` and
    ``resumed`` chunks of this process to ``<out>/<name>_rank<r>.npz``."""
    torch.set_num_threads(1)
    from ray_tpu_torch import convert
    from ray_tpu_torch.parallel.sharding import place_tree
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import CheckpointManager
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    ctx = session.get_context()
    c = config["case"]
    tr = Trainer(c["model_config"], TrainConfig(**c["train"]), device="cpu",
                 process_group=ctx.process_group)

    def dump(name, state, **extra):
        flat = dict(extra)
        for tree in ("params", "mu", "nu"):
            node = state.params if tree == "params" else \
                state.opt_state[tree]
            flat.update(placed_chunks(node, tr.mesh, f"{tree}."))
        np.savez(os.path.join(config["out"], f"{name}_rank{ctx.rank}.npz"),
                 **flat)

    restore = session.get_checkpoint_dir()
    if restore is None:
        params = convert.params_from_numpy(c["model_config"], c["params"],
                                           device="cpu")
        state = place_tree(TrainState.create(params, tr.optimizer),
                           tr.state_shardings())
        state, m = tr.train_step(state, c["batches"][0])
        ckpt = os.path.join(ctx.trial_dir, "ckpt_1")
        CheckpointManager(ckpt, async_save=False).save(state.step, state)
        dump("saved", state, losses=[float(m["loss"])],
             grad_norms=[float(m["grad_norm"])])
        # every process's chunks are on disk before rank 0 names the
        # checkpoint
        ctx.process_group.all_reduce(torch.zeros(1))
        session.report({"step": state.step}, checkpoint_dir=ckpt)
        raise RuntimeError("transient-failure")
    state = CheckpointManager(restore).restore(
        shardings=tr.state_shardings())
    dump("restored", state, checkpoint_dir=restore)
    losses, norms = [], []
    for batch in c["batches"][state.step:]:
        state, m = tr.train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    dump("resumed", state, losses=losses, grad_norms=norms)
    session.report({"step": state.step})


def collectives_across_loop(config):
    """Each collective of ``parallel.collectives`` across processes on a
    line of ``config["axes"]`` (``config["axis"]``), forward and backward:
    this rank's input, seeded by the rank, and a seeded cotangent; the
    outputs and input gradients to ``<out>/<op>_rank<r>.npz``. Then all
    again with the staging through the host buffer taken for these CPU
    tensors, in rounds of at most ``config["staged_bucket_bytes"]``, to
    ``<out>/<op>_staged_rank<r>.npz``; each with the op's staged bytes and
    the largest staging buffer so far."""
    torch.set_num_threads(1)
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel import process_group as pgm
    from ray_tpu_torch.parallel.process_group import mesh_layout
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    pg = ctx.process_group
    layout = mesh_layout(pg, config["axes"])
    group = layout.groups[config["axis"]]
    for tag in ("", "_staged"):
        if tag:
            pgm.BUCKET_BYTES = config["staged_bucket_bytes"]
            pg._staged = lambda t: True
        for op, (shape, fn) in config["ops"].items():
            staged_before = pg.stats["staged_bytes"]
            rng = np.random.default_rng(100 + ctx.rank)
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).requires_grad_(True)
            if fn[0] == "copy_to_group":
                out = [col.copy_to_group(x, group)]
            elif fn[0] == "ulysses_attention":
                # q, k and v stacked on a leading axis
                from ray_tpu_torch.parallel.ulysses import ulysses_attention

                out = ulysses_attention(*([t] for t in x.unbind(0)),
                                        group=group)
            else:
                out = getattr(col, fn[0])([x], group=group, **fn[1])
            y = out[0]
            cot = torch.from_numpy(np.random.default_rng(200 + ctx.rank)
                                   .standard_normal(tuple(y.shape))
                                   .astype(np.float32))
            (grad,) = torch.autograd.grad(y, x, cot) if y.requires_grad \
                else (torch.zeros_like(x),)
            np.savez(os.path.join(config["out"],
                                  f"{op}{tag}_rank{ctx.rank}.npz"),
                     y=y.detach().numpy(), grad=grad.numpy(),
                     index=group.index, stats_calls=sum(
                         v for k, v in pg.stats.items()
                         if k.endswith("_calls")),
                     staged_bytes=pg.stats["staged_bytes"] - staged_before,
                     buffer_bytes=max((b.numel() * b.element_size()
                                       for b in pg._pinned.values()),
                                      default=0))


def ranged_chunks(tree, prefix="") -> dict:
    """``{"<leaf>|<index range>": chunk}`` for every distinct chunk of this
    process's places (a plain tensor: its whole range), the range as
    ``train.checkpoint`` keys it."""
    from ray_tpu_torch.train.checkpoint import _range_key

    out = {}
    for name, st in tree.items():
        if isinstance(st, dict):
            out.update(ranged_chunks(st, f"{prefix}{name}."))
        elif hasattr(st, "chunks"):
            idx = st.sharding.indices(st.shape)
            for place, c in st.distinct():
                out[f"{prefix}{name}|{_range_key(idx[place])}"] = \
                    c.detach().numpy()
        else:
            out[f"{prefix}{name}|{_range_key([slice(0, n) for n in st.shape])}"] \
                = st.detach().numpy()
    return out


def _process_mesh(pg, axes):
    """This process's part of the global mesh ``axes``, every place on
    the CPU."""
    import math

    from ray_tpu_torch.parallel.mesh import Mesh, create_mesh
    from ray_tpu_torch.parallel.process_group import mesh_layout

    layout = mesh_layout(pg, axes)
    local = create_mesh(layout.local, devices=["cpu"] * math.prod(
        layout.local.values()))
    return Mesh(local.devices, local.axis_names, layout)


def _forward_case(ctx, name, c, out):
    """Mixtral's ``spmd.placed_forward`` under moe on this process's part
    of the global mesh ``c["axes"]``, from the shared weights: its logit
    rows, the aux loss, each routing's kept and assigned top-k slots, and
    the shapes each of its ``_expert_ffn`` calls saw, to
    ``<out>/<name>_rank<r>.npz``."""
    import contextlib

    from ray_tpu_torch import convert
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.sharding import PRESETS, shard_tree
    from ray_tpu_torch.train import spmd

    cfg = c["model_config"]
    mesh = _process_mesh(ctx.process_group, c["axes"])
    params = convert.params_from_numpy(cfg, c["params"], device="cpu")
    placed = shard_tree(params, mixtral.param_logical_axes(cfg), mesh,
                        PRESETS["moe"])
    routed, experts = [], []
    route, ffn = spmd.router_topk, spmd._expert_ffn

    def router_topk(logits, top_k, capacity):
        dispatch, combine, aux = route(logits, top_k=top_k,
                                       capacity=capacity)
        routed.append((float(dispatch.sum()), logits.shape[0] * top_k))
        return dispatch, combine, aux

    def expert_ffn(x, w_gate, w_up, w_down):
        experts.append(tuple(x.shape) + tuple(w_gate.shape))
        return ffn(x, w_gate, w_up, w_down)
    with contextlib.ExitStack() as stack:
        _controls(c.get("control"), stack)
        spmd.router_topk, spmd._expert_ffn = router_topk, expert_ffn
        stack.callback(setattr, spmd, "router_topk", route)
        stack.callback(setattr, spmd, "_expert_ffn", ffn)
        with torch.no_grad():
            logits, aux = spmd.placed_forward(
                mixtral, cfg, placed, torch.as_tensor(c["tokens"]),
                mesh=mesh, rules=PRESETS["moe"], return_aux_loss=True)
    np.savez(os.path.join(out, f"{name}_rank{ctx.rank}.npz"),
             logits=logits.numpy(), aux=float(aux),
             routed=np.array(routed), experts=np.array(experts))


def elastic_axes(n: int) -> dict:
    """The elastic cases' mesh for ``n`` places: {fsdp 2, tp n/2}, or
    {fsdp n} for two or fewer."""
    return {"fsdp": 2, "tp": n // 2} if n > 2 else {"fsdp": n}


def _elastic_job(ctx, job, out):
    """``ElasticTrainer(process_group=)`` over this world: ``job["steps"]``
    steps from the shared weights, a checkpoint at the last (every
    process its chunks); then the first ``job["survivors"]`` ranks leave
    this group, join a new one of their own and ``reform`` onto it,
    restoring that checkpoint, and take the remaining batches. Writes
    ``saved``, ``restored`` and ``after`` chunks (by index range, and
    after the last step by place) with the losses, norms and the reform
    event to ``<out>/<stage>_rank<r>.npz``; the others leave after
    saving."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.parallel.process_group import (free_port,
                                                      init_process_group)
    from ray_tpu_torch.parallel.sharding import place_tree
    from ray_tpu_torch.train.elastic import ElasticTrainer
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.telemetry import run_goodput
    from ray_tpu_torch.train.trainer import TrainConfig

    pg, rank = ctx.process_group, ctx.rank
    cfg, steps, batches = job["model_config"], job["steps"], job["batches"]
    run = f"elastic-rank{rank}"
    et = ElasticTrainer(cfg, TrainConfig(**job["train"]),
                        checkpoint_dir=job["checkpoint_dir"],
                        mesh_axes_fn=elastic_axes, devices=["cpu"],
                        checkpoint_every=steps, run_name=run,
                        process_group=pg)
    params = convert.params_from_numpy(cfg, job["params"], device="cpu")
    state = place_tree(TrainState.create(params, et.trainer.optimizer),
                       et.trainer.state_shardings())
    metrics = []

    def dump(stage, state, **extra):
        trees = {"params": state.params, **{
            k: state.opt_state[k] for k in ("mu", "nu")}}
        flat = {**extra, "step": state.step,
                "count": state.opt_state["count"]}
        for t, tree in trees.items():
            flat.update(ranged_chunks(tree, f"{t}."))
            flat.update(placed_chunks(tree, et.trainer.mesh, f"{t}."))
        np.savez(os.path.join(out, f"{stage}_rank{rank}.npz"), **flat)

    state = et.fit(state, iter(batches[:steps]), steps=steps,
                   on_metrics=metrics.append)
    et.ckpt.wait()
    dump("saved", state, losses=[m["loss"] for m in metrics],
         grad_norms=[m["grad_norm"] for m in metrics])
    port = pg.all_gather_object(free_port() if rank == 0 else None)[0]
    # every process's file is on disk before any survivor restores
    pg.all_reduce(torch.zeros(1))
    if rank >= job["survivors"]:
        et.close()
        return
    pg.destroy()
    new = init_process_group("gloo", rank, job["survivors"], port,
                             use_gpu=False)
    state = et.reform(process_group=new)
    event = et.reform_events[0]
    dump("restored", state)
    metrics.clear()
    state = et.fit(state, iter(batches[steps:]),
                   steps=len(batches) - steps, on_metrics=metrics.append)
    dump("after", state, losses=[m["loss"] for m in metrics],
         grad_norms=[m["grad_norm"] for m in metrics],
         event=[event.step, event.old_devices, event.new_devices,
                event.seconds],
         restart_s=run_goodput(run)["restart"],
         mesh=str(et.trainer.mesh.shape))
    et.close()
    new.destroy()


def _toy_stage(sp, x):
    return torch.tanh(x @ sp["w"])


def _toy_head(io, y, t, m):
    logits = y @ io["emb"].T          # tied: the embedding is the head
    lse = torch.logsumexp(logits, -1)
    tl = logits.gather(-1, t.long()[..., None])[..., 0]
    return ((lse - tl) * m).sum(), m.sum()


def _pipeline_case(ctx, toy, out):
    """``pipeline_value_and_grad`` on the toy of
    ``tests/test_torch_pipeline.py`` over {pp world}, this process's stage
    alone, with and without ``embed_fn``: the sums, its stage's gradient,
    the io and input gradients to ``<out>/pipeline_<embed>_rank<r>.npz``."""
    from ray_tpu_torch.parallel.pipeline import pipeline_value_and_grad

    mesh = _process_mesh(ctx.process_group, {"pp": ctx.world_size})
    t = {k: torch.from_numpy(v) for k, v in toy.items()}
    for embed in (False, True):
        xs = t["tok"] if embed else t["x"]
        (loss, weight), (d_sp, d_io, d_x) = pipeline_value_and_grad(
            _toy_stage, _toy_head, [{"w": t["w"][ctx.rank]}],
            {"emb": t["emb"]}, xs, t["tgt"], t["msk"], mesh=mesh,
            embed_fn=(lambda io, tok: io["emb"][tok.long()]) if embed
            else None, like=t["x"][0] if embed else None)
        np.savez(os.path.join(out, f"pipeline_{embed}_rank{ctx.rank}.npz"),
                 loss=float(loss), weight=float(weight),
                 d_w=d_sp[0]["w"].numpy(), d_emb=d_io["emb"].numpy(),
                 **({} if d_x is None else {"d_x": d_x.numpy()}))


def spanned_loop(config):
    """The pp, ep and elastic cases of one world, in order: the 1F1B on
    a toy (``config["pipeline"]``, ``_pipeline_case``), the trainer
    cases ``config["train"]`` (``cross_process_loop``'s), the forward
    cases ``config["forward"]`` (``_forward_case``), then
    ``config["elastic"]`` (last: its survivors leave this world's group)."""
    torch.set_num_threads(1)
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    if config.get("pipeline"):
        _pipeline_case(ctx, config["pipeline"], config["out"])
    if config.get("train"):
        cross_process_loop({"cases": config["train"], "out": config["out"]})
    for name, c in config.get("forward", {}).items():
        _forward_case(ctx, name, c, config["out"])
        session.report({"case": name})
    if config.get("elastic"):
        _elastic_job(ctx, config["elastic"], config["out"])


def _cut_collectives(ctx, c, out):
    """Each collective of ``parallel.collectives`` over the axis
    ``c["axis"]`` of ``c["axes"]``, cut at the process boundary: this
    process's ``k`` chunks, each seeded by its global index, forward and
    backward against seeded cotangents; every chunk's output and input
    gradient, and the axis' size, to ``<out>/cut_<op>_rank<r>.npz``."""
    from functools import partial

    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = _process_mesh(ctx.process_group, c["axes"])
    axis = c["axis"]
    group, k, first = mesh.group(axis), mesh.local_shape[axis], \
        mesh.offset(axis)

    def seeded(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32))
    for op, (shape, (fn, kw)) in c["ops"].items():
        xs = [seeded(100 + first + i, shape).requires_grad_(True)
              for i in range(k)]
        if fn == "copy_to_group":
            ys = [col.copy_to_group(x, group) for x in xs]
        elif fn == "ulysses_attention":
            ys = ulysses_attention(*([x[i] for x in xs] for i in range(3)),
                                   group=group)
        elif fn == "logsumexp":
            ys = col.logsumexp(xs, reduce=partial(col.psum, group=group),
                               group=group)
        else:
            ys = getattr(col, fn)(xs, group=group, **kw)
        cots = [seeded(200 + first + i, tuple(y.shape))
                for i, y in enumerate(ys)]
        grads = torch.autograd.grad(ys, xs, cots) if ys[0].requires_grad \
            else [torch.zeros_like(x) for x in xs]
        np.savez(os.path.join(out, f"cut_{op}_rank{ctx.rank}.npz"),
                 size=col.axis_size(xs, group=group), first=first,
                 **{f"y{i}": y.detach().numpy() for i, y in enumerate(ys)},
                 **{f"grad{i}": g.numpy() for i, g in enumerate(grads)})


def tp_axes(n: int) -> dict:
    """The cut elastic job's mesh for ``n`` places: {tp n}."""
    return {"tp": n}


def _cut_elastic_job(ctx, job, out):
    """``ElasticTrainer(process_group=)`` over this world, its places
    each process's ``job["devices"][0]``, one step a stage, a checkpoint
    after each (every process its chunks); before each later stage every
    process reforms onto its next devices (``job["devices"][i]``: one
    place a process {tp 2}, two {tp 4}, whose process boundary cuts tp),
    restoring the last checkpoint. Writes the chunks (by index range) it
    saved before and restored after each reform to
    ``<out>/cut_elastic_rank<r>.npz`` (``saved<i>.``, ``restored<i>.``),
    with the final chunks by place, the losses and the norms."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.parallel.sharding import place_tree
    from ray_tpu_torch.train.elastic import ElasticTrainer
    from ray_tpu_torch.train.state import TrainState
    from ray_tpu_torch.train.trainer import TrainConfig

    pg, rank = ctx.process_group, ctx.rank
    cfg = job["model_config"]
    et = ElasticTrainer(cfg, TrainConfig(**job["train"]),
                        checkpoint_dir=job["checkpoint_dir"],
                        mesh_axes_fn=tp_axes, devices=job["devices"][0],
                        checkpoint_every=1, run_name=f"cut-elastic-{rank}",
                        process_group=pg)
    params = convert.params_from_numpy(cfg, job["params"], device="cpu")
    state = place_tree(TrainState.create(params, et.trainer.optimizer),
                       et.trainer.state_shardings())
    flat, metrics = {}, []

    def dump(state, prefix):
        # copies: the steps after update the chunks in place
        for t in ("params", "mu", "nu"):
            tree = state.params if t == "params" else state.opt_state[t]
            flat.update({k: v.copy() for k, v in ranged_chunks(
                tree, f"{prefix}.{t}.").items()})
    for i, devices in enumerate(job["devices"]):
        if i:
            et.ckpt.wait()
            dump(state, f"saved{i}")
            # every process's file is on disk before any restores
            pg.all_reduce(torch.zeros(1))
            state = et.reform(devices=devices, process_group=pg)
            dump(state, f"restored{i}")
        state = et.fit(state, iter(job["batches"][i:i + 1]), steps=1,
                       on_metrics=metrics.append)
    for t in ("params", "mu", "nu"):
        tree = state.params if t == "params" else state.opt_state[t]
        flat.update(placed_chunks(tree, et.trainer.mesh, f"{t}."))
    np.savez(os.path.join(out, f"cut_elastic_rank{rank}.npz"), **flat,
             losses=[m["loss"] for m in metrics],
             grad_norms=[m["grad_norm"] for m in metrics],
             mesh=str(et.trainer.mesh.shape))
    et.close()


def cut_loop(config):
    """The cases of layouts with an axis cut at the process boundary, in
    order: the trainer cases ``config["train"]``
    (``cross_process_loop``'s), the forward cases ``config["forward"]``
    (``_forward_case``), the collectives ``config["collectives"]``
    (``_cut_collectives``), then the elastic job ``config["elastic"]``
    (``_cut_elastic_job``)."""
    torch.set_num_threads(1)
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    cross_process_loop({"cases": config["train"], "out": config["out"]})
    for name, c in config["forward"].items():
        _forward_case(ctx, name, c, config["out"])
        session.report({"case": name})
    _cut_collectives(ctx, config["collectives"], config["out"])
    _cut_elastic_job(ctx, config["elastic"], config["out"])
