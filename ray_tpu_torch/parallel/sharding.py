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

``logical_sharding`` returns a ``PartitionSpec``: one entry per dimension,
each a mesh axis, a tuple of mesh axes or None (replicated), as JAX's
``PartitionSpec`` holds them. Placing tensors by these specs
(``tree_shardings``, ``shard_tree``, ``replicated``, ``batch_sharding``)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

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


def logical_sharding(logical: tuple, mesh: Mesh,
                     rules: ShardingRules) -> PartitionSpec:
    """The partition spec of one array annotated with logical axis names,
    on ``mesh`` (JAX returns it inside a ``NamedSharding``)."""
    return _filter_spec_for_mesh(rules.mesh_axes(logical), mesh)
