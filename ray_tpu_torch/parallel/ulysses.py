"""Ulysses sequence parallelism: attention through a head/sequence
all-to-all.

Port of ``ray_tpu/parallel/ulysses.py`` (the DeepSpeed-Ulysses scheme,
Jacobs et al. 2023). Activations are cut along the SEQUENCE over the
``sp`` ranks everywhere but inside attention; at the attention boundary an
all-to-all re-cuts them along the HEADS (each rank sees the whole
sequence for its share of the heads), dense attention runs on each rank,
and a second all-to-all restores the sequence cut. Attention inside is
``reference_attention``, as in JAX.

Against ring attention (``parallel/ring_attention.py``): Ulysses moves
the activations twice and keeps attention dense, the ring keeps them in
place and rotates K/V; Ulysses needs every head count divisible by the
sp size (GQA kv-head counts below it cannot be re-cut by head).

The port is single-controller (``parallel.mesh``): ``ulysses_attention``
takes the ranks' sequence chunks as one list in mesh order and returns
the list of output chunks; ``ulysses_attention_sharded`` cuts global
inputs over the mesh axis and joins the result. Across processes
(``group=``, the sp axis' ``AxisGroup``) the lists hold this process's
chunks, one for each of its sp ranks (the run of consecutive ranks of a
cut axis, ``parallel.mesh``), and both all-to-alls run over them and the
subgroup, each differentiable through the inverse exchange
(``parallel.collectives``).
"""

from __future__ import annotations

from ray_tpu_torch.ops.attention import reference_attention
from ray_tpu_torch.parallel import collectives as col


def ulysses_attention(qs: list, ks: list, vs: list, *, causal: bool = True,
                      scale: float | None = None, group=None) -> list:
    """Per-rank sequence chunks [B, S/sp, H, D] (one list entry per rank
    along the sp axis, in order) -> per-rank output chunks, with
    whole-sequence attention semantics. Every head count must be
    divisible by the sp size."""
    sp = col.axis_size(qs, group=group)
    d = qs[0].shape[-1]
    for name, xs in (("q", qs), ("k", ks), ("v", vs)):
        if xs[0].shape[2] % sp != 0:
            raise ValueError(
                f"Ulysses requires {name} heads ({xs[0].shape[2]}) divisible "
                f"by sp axis ({sp}) — GQA kv-head counts below sp can't "
                "re-shard by head; use ring attention instead")
    if scale is None:
        scale = d ** -0.5

    # [B, S/sp, H, D] -> [B, S, H/sp, D]: scatter heads, gather sequence
    def to_heads(xs):
        return col.all_to_all(xs, split_axis=2, concat_axis=1, group=group)

    def to_seq(xs):
        return col.all_to_all(xs, split_axis=1, concat_axis=2, group=group)

    out = [reference_attention(q, k, v, causal=causal, scale=scale)
           for q, k, v in zip(to_heads(qs), to_heads(ks), to_heads(vs))]
    return to_seq(out)


def ulysses_attention_sharded(mesh, q, k, v, *, axis: str = "sp",
                              causal: bool = True,
                              scale: float | None = None):
    """Top-level entry: cuts [B, S, H, D] inputs along the sequence
    over ``axis`` of ``mesh`` (the devices along it, at index 0 of any
    other axis), runs ``ulysses_attention`` and joins the output on q's
    device. Where ``axis`` spans processes the inputs and the output are
    this process's chunk of the sequence."""
    devices = mesh.axis_devices(axis)
    group = mesh.group(axis) if mesh.spans(axis) else None
    qs, ks, vs = (col.shard(x, devices, 1) for x in (q, k, v))
    out = ulysses_attention(qs, ks, vs, causal=causal, scale=scale,
                            group=group)
    return col.unshard(out, 1, q.device)
