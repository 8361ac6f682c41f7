"""Logical-axis sharding rules -> partition specs over a mesh.

Port of the rule tables of ``ray_tpu/parallel/sharding.py``. Every array
of a model carries *logical* axis names; a rule table maps each logical
axis onto mesh axes. Changing the parallelism strategy is swapping the
rule table; the model code never changes. The trainer reads ``rules.seq``
to decide on ring attention (``train/trainer.py``).

Logical axes used by the model library:

    batch    - per-example batch dim        -> dp/fsdp (data parallel)
    seq      - sequence/token dim           -> sp (sequence parallel)
    embed    - model (d_model) dim          -> fsdp
    heads    - attention heads              -> tp
    kv_heads - kv heads (GQA)               -> tp
    mlp      - FFN hidden dim               -> tp
    vocab    - vocabulary dim               -> tp
    expert   - MoE expert dim               -> ep
    layers   - stacked layer dim            -> pp (pipeline parallel)
    stage    - pipeline stage dim           -> pp
    (None)   - replicated

``logical_sharding`` returns a ``NamedSharding``: the mesh and a
``PartitionSpec`` (``.spec``), one entry per dimension, each a mesh axis,
a tuple of mesh axes or None (replicated), as JAX's ``PartitionSpec``
holds them.

**Placement** (``device_put``, ``shard_tree``). The mesh is
single-controller (``parallel.mesh``): one process holds every place. A
placed tensor, ``ShardedTensor``, keeps the global shape, the sharding
and one chunk per place of the mesh, in the order of
``mesh.devices.ravel()`` (row-major, ``AXIS_ORDER`` outer to inner). Chunk
``i`` is the index range JAX's ``NamedSharding`` gives the device at flat
position ``i`` of a mesh of the same shape: a dimension cut over axes
``(a, b)`` is cut into ``|a|·|b|`` equal pieces, ``a`` major. Places that
hold the same index range on the same device share one tensor object,
and a chunk on the device of the tensor it was cut from is a view of it:
nothing is copied on one card. A dp-4 state on one card therefore costs
its 64 GB once, not four times; only a place on another device gets a
copy. Chunks are leaves that share storage, so updating one in place
updates the tensor it was cut from and every place that shares it.

**Across processes** (a mesh with a ``ProcessLayout``, ``parallel.mesh``)
a process holds the chunks of its own places only, in the order of its
``mesh.devices.ravel()``, each the index range of that place's global
coordinates; ``distinct()`` lists them. ``device_put`` of a tensor cut over a
spanned axis copies each chunk (a view would keep the global tensor
alive in every process), and ``unshard`` of a tensor cut over a spanned
axis (wholly or cut at the process boundary) is an explicit all-gather
over that axis' subgroup, a collective every process of the line must
make.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import Mesh


class PartitionSpec(tuple):
    """Mesh axes per dimension, normalized as
    ``jax.sharding.PartitionSpec`` normalizes them: a list becomes a
    tuple, and a tuple of one axis that axis."""

    __slots__ = ()

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Axes(tuple):
    """Marker type for a logical-axes annotation leaf. Distinguishable
    from namedtuples (e.g. optimizer states) when used as a tree leaf
    predicate."""

    __slots__ = ()


def is_axes_leaf(x) -> bool:
    """True for annotation leaves: an ``Axes`` marker, or a plain tuple of
    axis entries (str/None/tuple-of-str). Namedtuple containers are NOT
    leaves even though they subclass tuple."""
    if isinstance(x, Axes):
        return True
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return all(
            e is None or isinstance(e, str)
            or (isinstance(e, (tuple, list))
                and all(isinstance(s, str) for s in e))
            for e in x
        )
    return False


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis name to mesh axis (or tuple of mesh axes,
    or None for replicated)."""

    batch: Any = ("dp", "fsdp")
    seq: Any = None
    embed: Any = None
    heads: Any = None
    kv_heads: Any = None
    mlp: Any = None
    vocab: Any = None
    expert: Any = None
    layers: Any = None
    stage: Any = None

    def mesh_axes(self, logical: tuple) -> PartitionSpec:
        return P(*(None if ax is None else getattr(self, ax)
                   for ax in logical))

    def with_overrides(self, **kw) -> "ShardingRules":
        return replace(self, **kw)


# --- presets (the parallelism inventory as one-liners) ---

# Pure data parallel: params replicated, batch split.
DP_RULES = ShardingRules(batch=("dp", "fsdp"))

# Fully-sharded data parallel (ZeRO-3 analog): params/grads/optimizer
# sharded on the fsdp axis; batch split over dp x fsdp.
FSDP_RULES = ShardingRules(batch=("dp", "fsdp"), embed="fsdp")

# Megatron-style tensor parallel: heads/mlp/vocab split on tp.
TP_RULES = ShardingRules(batch=("dp", "fsdp"), heads="tp", kv_heads="tp",
                         mlp="tp", vocab="tp")

# FSDP x TP (the common 2D layout for 7B+ models).
FSDP_TP_RULES = ShardingRules(
    batch=("dp", "fsdp"), embed="fsdp", heads="tp", kv_heads="tp", mlp="tp",
    vocab="tp",
)

# + sequence parallel: activations sharded along seq on the sp axis.
FSDP_TP_SP_RULES = FSDP_TP_RULES.with_overrides(seq="sp")

# MoE: experts split on ep, everything else as FSDP x TP.
MOE_RULES = FSDP_TP_RULES.with_overrides(expert="ep")

# Pipeline parallel: the stacked layer dim split over pp, everything else
# FSDP x TP (tp entries drop out on meshes without a tp axis).
PP_FSDP_RULES = FSDP_TP_RULES.with_overrides(layers="pp")

PRESETS = {
    "dp": DP_RULES,
    "fsdp": FSDP_RULES,
    "tp": TP_RULES,
    "fsdp_tp": FSDP_TP_RULES,
    "fsdp_tp_sp": FSDP_TP_SP_RULES,
    "moe": MOE_RULES,
    "pp_fsdp": PP_FSDP_RULES,
}


def _filter_spec_for_mesh(spec: PartitionSpec, mesh: Mesh) -> PartitionSpec:
    """Drop mesh axes the mesh doesn't have (so FSDP_TP rules work on a
    dp-only mesh: tp entries become replicated), and drop repeated uses of
    a mesh axis (first dim wins): one array can map each mesh axis to at
    most one positional dimension."""
    names = set(mesh.axis_names)
    used: set = set()

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = []
            for e in entry:
                if e in names and e not in used:
                    used.add(e)
                    kept.append(e)
            return tuple(kept) if kept else None
        if entry in names and entry not in used:
            used.add(entry)
            return entry
        return None

    return P(*(keep(e) for e in spec))


def _axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def same_device(a: torch.device, b: torch.device) -> bool:
    """True when ``a`` and ``b`` name one device ("cuda" is the current
    card, "cpu" is "cpu:0")."""
    def norm(d):
        d = torch.device(d)
        if d.index is not None:
            return d
        return torch.device(d.type, torch.cuda.current_device()
                            if d.type == "cuda" else 0)
    return norm(a) == norm(b)


class NamedSharding:
    """A mesh and a partition spec (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for entry in self.spec:
            for ax in _axes_of(entry):
                if ax not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {ax!r}, "
                                     f"not on the mesh {mesh.shape}")

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec})"

    def cut_axes(self) -> set:
        """The mesh axes the spec cuts over."""
        return {a for entry in self.spec for a in _axes_of(entry)}

    def spans_processes(self) -> bool:
        """Whether some process lacks some index range: the spec cuts
        over an axis whose places lie in several processes."""
        return any(self.mesh.spans(a) for a in self.cut_axes())

    def shard_shape(self, shape) -> tuple:
        """The shape of every chunk of a ``shape`` tensor."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{len(shape)}-d shape {shape}")
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in _axes_of(entry))
            if shape[d] % n:
                raise ValueError(f"dim {d} of {shape} is not divisible by "
                                 f"the {n} places of {entry!r}")
            out[d] = shape[d] // n
        return tuple(out)

    def indices(self, shape) -> list:
        """The index range of each place, in the order of
        ``mesh.devices.ravel()``: a tuple of slices per place (JAX's
        ``devices_indices_map``, keyed by position, as one device may
        fill several places; this process's places only, at their global
        coordinates, on a mesh across processes)."""
        chunk = self.shard_shape(shape)
        grid = self.mesh.devices.shape
        names = self.mesh.axis_names
        out = []
        for flat in range(self.mesh.devices.size):
            coords = dict(zip(names, self.mesh.global_coords(
                np.unravel_index(flat, grid))))
            idx = []
            for d in range(len(shape)):
                entry = self.spec[d] if d < len(self.spec) else None
                piece = 0
                for ax in _axes_of(entry):
                    piece = piece * self.mesh.shape[ax] + int(coords[ax])
                idx.append(slice(piece * chunk[d], (piece + 1) * chunk[d]))
            out.append(tuple(idx))
        return out


class ShardedTensor:
    """A tensor placed over a mesh: its global ``shape`` and ``dtype``, its
    ``sharding`` and ``chunks``, one per place in the order of
    ``mesh.devices.ravel()`` (see the module docstring: places holding
    one index range on one device share one tensor object)."""

    def __init__(self, shape, dtype, sharding: NamedSharding, chunks: list):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.chunks = list(chunks)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, {self.sharding})")

    def distinct(self) -> list:
        """(place, chunk) for the first place of each distinct chunk
        object, in place order."""
        seen, out = set(), []
        for place, chunk in enumerate(self.chunks):
            if id(chunk) not in seen:
                seen.add(id(chunk))
                out.append((place, chunk))
        return out

    def take(self, axis: str, index: int) -> "ShardedTensor":
        """The places at ``index`` of mesh axis ``axis`` (a pipeline
        stage; a local index, this process's stage where ``axis`` spans
        processes): a tensor on the mesh without that axis, holding the
        piece of the dimension cut over ``axis`` (which must lead its
        entry), with the same chunk objects."""
        mesh = self.mesh
        i = mesh.axis_names.index(axis)
        names = mesh.axis_names[:i] + mesh.axis_names[i + 1:]
        sub = Mesh(np.squeeze(mesh.devices.take([index], axis=i), axis=i),
                   names, mesh.layout.restrict(names) if mesh.layout
                   else None)
        shape, spec = list(self.shape), []
        for d, entry in enumerate(self.spec):
            axes = _axes_of(entry)
            if axis in axes:
                if axes[0] != axis:
                    raise ValueError(f"{axis!r} must lead the entry {entry} "
                                     "to take one of its pieces")
                shape[d] //= mesh.shape[axis]
                axes = axes[1:]
            spec.append(axes or None)
        grid = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
        places = grid.take(index, axis=i).ravel()
        return ShardedTensor(shape, self.dtype, NamedSharding(sub, P(*spec)),
                             [self.chunks[p] for p in places])

    def unshard(self, device=None) -> torch.Tensor:
        """The global tensor, assembled on ``device`` (default: the first
        chunk's) from one chunk of each index range. Cut over an axis that
        spans processes, this process's block is all-gathered over each
        such axis' subgroup (a collective: every process of the line
        calls it): a dimension cut over axes ``(a, b, ...)`` is this
        process's ``k_a × k_b × ...`` pieces, each axis' run of local
        indices gathered to the whole axis along its own place in the
        piece index, so that local axes may come before a spanned one."""
        device = device if device is not None else self.chunks[0].device
        mesh, chunk = self.mesh, self.sharding.shard_shape(self.shape)
        local = mesh.local_shape
        # the block: per dimension, the axes' local runs, then the chunk
        entries = [_axes_of(self.spec[d]) if d < len(self.spec) else ()
                   for d in range(len(self.shape))]
        runs = [[local[a] for a in axes] for axes in entries]
        out = torch.empty([x for r, c in zip(runs, chunk) for x in (*r, c)],
                          dtype=self.dtype, device=device)
        done = set()
        for flat, c in enumerate(self.chunks):
            coords = dict(zip(mesh.axis_names, np.unravel_index(
                flat, mesh.devices.shape)))
            at = tuple(int(coords[a]) for axes in entries for a in axes)
            if at in done:
                continue
            done.add(at)
            index, i = [], 0
            for axes in entries:
                index += [*at[i:i + len(axes)], slice(None)]
                i += len(axes)
            out[tuple(index)] = c.detach().to(device)
        at = 0
        for d, axes in enumerate(entries):
            for j, ax in enumerate(axes):
                if mesh.spans(ax):
                    from ray_tpu_torch.parallel.collectives import all_gather

                    out = all_gather([out], gather_axis=at + j,
                                     group=mesh.group(ax))[0]
            at += len(axes) + 1
        return out.reshape(self.shape)


def device_put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` placed by ``sharding``: each place gets its index range, a
    view of ``x`` (``x`` itself when the range is all of it) on ``x``'s
    device, a copy elsewhere; places with one range on one device share
    one chunk. When every place is on one other device, ``x`` moves there
    once and the chunks are views of that copy. Cut over an axis that
    spans processes, every chunk short of the whole tensor is a copy
    (module docstring)."""
    copy = sharding.spans_processes()
    devices = sharding.mesh.devices.ravel()
    if not same_device(x.device, devices[0]) and all(
            same_device(devices[0], d) for d in devices):
        x = x.to(devices[0])
    chunks, made = [], {}
    whole = tuple((0, n) for n in x.shape)
    for idx, dev in zip(sharding.indices(x.shape), devices):
        key = (tuple((s.start, s.stop) for s in idx), str(dev))
        if key not in made:
            if same_device(x.device, dev):
                made[key] = x if key[0] == whole else (
                    x.detach()[idx].clone() if copy else x.detach()[idx])
            else:
                made[key] = x.detach()[idx].to(dev, copy=True)
        chunks.append(made[key])
    return ShardedTensor(x.shape, x.dtype, sharding, chunks)


def logical_sharding(logical: tuple, mesh: Mesh,
                     rules: ShardingRules) -> NamedSharding:
    """The ``NamedSharding`` of one array annotated with logical axis
    names, on ``mesh``."""
    return NamedSharding(mesh,
                         _filter_spec_for_mesh(rules.mesh_axes(logical), mesh))


def map_trees(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest``. Nodes: dicts, lists, tuples that are not leaves and
    dataclasses (``TrainState``); everything else is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_trees(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Axes):
        return type(tree)(map_trees(fn, v, *(r[i] for r in rest),
                                    is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_trees(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest),
                         is_leaf=is_leaf)
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_shardings(logical_tree, mesh: Mesh, rules: ShardingRules):
    """Map a tree of logical-axis tuples (or ``Axes``) to a tree of
    ``NamedSharding``s."""
    return map_trees(
        lambda logical: logical_sharding(tuple(logical), mesh, rules),
        logical_tree, is_leaf=is_axes_leaf)


def place_tree(tree, shardings):
    """Place every tensor of ``tree`` by the matching ``NamedSharding`` of
    ``shardings`` (a tree of the same structure); other leaves (step
    counts) stay as they are."""
    def put(x, sharding):
        return device_put(x, sharding) if isinstance(x, torch.Tensor) else x
    return map_trees(put, tree, shardings,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))


def shard_tree(tree, logical_tree, mesh: Mesh, rules: ShardingRules):
    """Place a tree according to its logical annotations (JAX:
    ``jax.device_put(tree, tree_shardings(...))``)."""
    return place_tree(tree, tree_shardings(logical_tree, mesh, rules))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, rules: ShardingRules, ndim: int = 2,
                   *, shard_seq: bool = True) -> NamedSharding:
    """Sharding for an input batch [batch, seq, ...]: batch axis split per
    rules, sequence split if sp is active, rest replicated.

    ``shard_seq=False`` keeps the seq dim replicated: used for raw token
    batches of length S+1 (the shifted-target column makes S+1 typically
    indivisible by sp; ring attention cuts the sequence inside the step
    instead)."""
    logical = ("batch", "seq" if shard_seq else None) + (None,) * (ndim - 2)
    return logical_sharding(logical[:max(ndim, 0)], mesh, rules)
