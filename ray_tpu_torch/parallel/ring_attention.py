"""Ring attention: exact attention over a sequence cut across the ranks of
a mesh axis.

Port of ``ray_tpu/parallel/ring_attention.py``. The sequence is cut into
``n`` contiguous chunks over the ``axis`` ranks of the mesh; each rank
keeps its query chunk while the key/value chunks travel the ring
(``collectives.ring_shift``), and every rank merges its blockwise results
with an online log-sum-exp. The port is single-controller
(``parallel.mesh``): one call walks the ring, each step over every rank,
and on one card the ring's moves are no-ops.

Causality over the ring: at step ``r`` rank ``idx`` holds the kv chunk of
rank ``src = (idx - r) % n``:

    src <  idx  -> every key precedes every query -> full (unmasked) block
    src == idx  -> the diagonal block (step 0)    -> causal mask
    src >  idx  -> every key follows every query  -> skipped

Two bodies, as in JAX:

- ``reference``: blockwise attention in float32 (``_chunk_attention``)
  merged by ``_merge``, differentiated by autograd.
- ``flash``: ``_RingFlash``, one ``torch.autograd.Function`` over the
  ring's global tensors. Its forward runs K1 with lse on every step:
  causal on the diagonal, non-causal on the ``idx >= r`` steps off it. Each
  step's output is rounded to q's dtype before the float32 merge. Its
  backward runs ``ops.flash_attention.flash_bwd`` on every step with the
  final output and the merged lse (so P is the global probability and no
  per-step lse term exists); dq sums the steps' dq (each in q's dtype) in
  float32, and dk and dv ride the ring in float32 with the kv chunk they
  belong to, coming home after ``n`` hops, then are cast. These are JAX's
  rounding points. At sp 4 a causal ring launches K1 10 times (4 causal,
  6 non-causal) and the backward 10 times; a non-causal ring 16 and 16.

``impl="auto"`` takes flash on a CUDA tensor and the reference body on
the CPU, as JAX takes flash only on a TPU. Under ``impl="flash"`` a chunk
the kernels do not take here (fewer than 256 tokens, not a multiple of
128, a head dim other than 64, 128 or 256) raises; it never goes to the
reference body. On a CPU tensor the flash body runs the kernels' plain
versions.

**Across processes.** When ``axis`` spans processes (``Mesh.spans``),
q, k and v are this process's block, its chunk of the sequence, and
this process walks its ``k`` consecutive ring ranks (one where the axis
spans the processes one index each, more where the process boundary cuts
it; ``parallel.mesh``): K/V move between them here and by the subgroup's
sends and receives at each process boundary (``collectives.ring_shift``
with ``group=``, K and V stacked, every shift posted as one
``batch_isend_irecv``), the causal skips are decided per global rank
(rank ``idx`` runs the diagonal and the ``idx`` steps after it), and in
the flash body's backward dK and dV ride the ring home in float32, as on
one card. Every process makes every shift, skipped step or not, so that
the ring's sends pair up. The rings of the mesh's other places in this
process (its indices of the batch and head axes, every place of a
process on its rank's device) run as one: their rows and heads are one
batch of the same kernels, and their K/V blocks move in one exchange a
step.

Under the ``attn`` and ``dots_attn`` remat policies of ``models/llama.py``
the ring recomputes its forward in the backward, as JAX's ring does: its
custom VJP names no residual, and ``_RingFlash`` launches the kernels
directly rather than through the flash operator those policies save.
"""

from __future__ import annotations

import itertools
import math

import torch

from ray_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
from ray_tpu_torch.parallel import collectives as col

# the ring's move of K/V (and dK/dV) one rank on (a module attribute, so
# that a fault check can replace it)
ring_shift = col.ring_shift


def _chunk_attention(q, k, v, *, scale, mask):
    """Blockwise attention: (o, lse). q [b, sq, h, d]; k and v
    [b, sk, hk, d] (GQA repeat applied here); ``mask`` [sq, sk] bool or
    None. o [b, sq, h, d] float32 (already divided by this block's
    denominator); lse [b, sq, h], the log-sum-exp of this block's logits."""
    h, hk = q.shape[2], k.shape[2]
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)               # [b, h, sq]
    probs = torch.exp(logits - lse[..., None])
    probs = torch.where(torch.isfinite(lse)[..., None], probs, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return o, lse.transpose(1, 2)


def _merge(o1, lse1, o2, lse2):
    """Merge two partial attention results (log-sum-exp weighted); lse has
    o's shape without its last dim."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.where(torch.isfinite(lse1), torch.exp(lse1 - lse), 0.0)
    w2 = torch.where(torch.isfinite(lse2), torch.exp(lse2 - lse), 0.0)
    return o1 * w1[..., None] + o2 * w2[..., None], lse


def _skipped(causal: bool, r: int, idx: int) -> bool:
    """At step r > 0, rank idx holds the kv chunk of rank (idx - r) % n,
    which comes after every query of rank idx when idx < r."""
    return causal and r > 0 and idx < r


class _Ring:
    """The ranks of one ring this process walks: ``idxs`` (all ``n`` on
    one mesh; this process's ``k`` consecutive global indices from
    ``first`` across processes) and the shift of their chunks one rank
    on."""

    def __init__(self, n: int, k: int | None = None, group=None,
                 first: int = 0):
        self.n, self.group = n, group
        self.idxs = range(first, first + (n if k is None else k))

    def shift(self, xs: list) -> list:
        return ring_shift(xs) if self.group is None else \
            ring_shift(xs, group=self.group)

    def shift_pair(self, ks: list, vs: list) -> tuple:
        """K and V one rank on; across processes in one exchange."""
        if self.group is None:
            return self.shift(ks), self.shift(vs)
        kvs = self.shift([torch.stack([k, v]) for k, v in zip(ks, vs)])
        return [kv[0] for kv in kvs], [kv[1] for kv in kvs]


def _ring_reference(qs, ks, vs, ring, scale, causal):
    """The reference body over the ring ranks' chunks [b, sc, h|hk, d]
    that this process walks: per rank the output in q's dtype,
    differentiated by autograd through the shifts. K and V ride the ring
    stacked, one chain of shifts, so that across processes the backward's
    reverse shifts come in one order in every process; a chain link whose
    step a rank skips still reaches that rank's output (times zero), so
    that every process runs every link's backward, which its ring
    neighbours wait for."""
    sc = qs[0].shape[1]
    kvs = [torch.stack([k, v]) for k, v in zip(ks, vs)]
    os_, lses = [None] * len(qs), [None] * len(qs)
    idle = [[] for _ in qs]
    for r in range(ring.n):
        for j, idx in enumerate(ring.idxs):
            if _skipped(causal, r, idx):
                idle[j].append(kvs[j])
                continue
            mask = None
            if causal and r == 0:
                mask = torch.ones(sc, sc, dtype=torch.bool,
                                  device=qs[j].device).tril()
            o_r, lse_r = _chunk_attention(qs[j], kvs[j][0], kvs[j][1],
                                          scale=scale, mask=mask)
            if r == 0:
                os_[j], lses[j] = o_r, lse_r
            else:
                os_[j], lses[j] = _merge(os_[j], lses[j], o_r, lse_r)
        if r < ring.n - 1:
            kvs = ring.shift(kvs)
    for j, xs in enumerate(idle):
        for x in xs:
            os_[j] = os_[j] + 0.0 * x.sum()
    return [o.to(q.dtype) for o, q in zip(os_, qs)]


def _ring_flash_fwd(qs, ks, vs, ring, scale, causal):
    """The forward ring on kernel-layout chunks [b, h|hk, sc, d]: per rank
    (out in q's dtype, merged lse float32 [b, h, sc])."""
    os_, lses = [None] * len(qs), [None] * len(qs)
    for r in range(ring.n):
        for j, idx in enumerate(ring.idxs):
            if _skipped(causal, r, idx):
                continue
            o_r, lse_r = flash_fwd(qs[j], ks[j], vs[j], scale=scale,
                                   causal=causal and r == 0, with_lse=True)
            if r == 0:
                os_[j], lses[j] = o_r.float(), lse_r
            else:
                os_[j], lses[j] = _merge(os_[j], lses[j], o_r.float(), lse_r)
        if r < ring.n - 1:
            ks, vs = ring.shift_pair(ks, vs)
    return [o.to(q.dtype) for o, q in zip(os_, qs)], lses


def _ring_flash_bwd(qs, ks, vs, os_, lses, dos, ring, scale, causal):
    """The backward ring: per rank (dq, dk, dv) in the inputs' dtypes. dq
    accumulates in float32 at home; dk and dv accumulate in float32 while
    they ride the ring with their kv chunk, and are home after n hops."""
    m = len(qs)
    dqs, dks, dvs = [None] * m, [None] * m, [None] * m
    for r in range(ring.n):
        for j, idx in enumerate(ring.idxs):
            if _skipped(causal, r, idx):
                continue
            dq, dk, dv = flash_bwd(qs[j], ks[j], vs[j], os_[j], lses[j],
                                   dos[j], scale=scale,
                                   causal=causal and r == 0)
            if r == 0:
                dqs[j], dks[j], dvs[j] = dq.float(), dk.float(), dv.float()
            else:
                dqs[j] = dqs[j] + dq.float()
                dks[j] = dks[j] + dk.float()
                dvs[j] = dvs[j] + dv.float()
        dks, dvs = ring.shift_pair(dks, dvs)
        if r < ring.n - 1:
            ks, vs = ring.shift_pair(ks, vs)
    return ([x.to(qs[0].dtype) for x in dqs], [x.to(ks[0].dtype) for x in dks],
            [x.to(vs[0].dtype) for x in dvs])


def _kernel_chunks(x, devices):
    """[b, s, heads, d] as per-rank kernel-layout views [b, heads, sc, d]
    (read through strides, no copy on one card)."""
    return col.shard(x.transpose(1, 2), devices, 2)


def _global(xs, device):
    """Per-rank kernel-layout chunks back to one [b, s, heads, d] tensor."""
    return col.unshard([x.transpose(1, 2) for x in xs], 1, device)


class _RingFlash(torch.autograd.Function):
    """The flash body over one ring, on global [b, s, h|hk, d] tensors
    cut over ``devices`` (across processes, this process's chunk of them,
    cut over its ring ranks' devices); both passes walk the ``ring``
    (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, devices, ring, scale, causal):
        os_, lses = _ring_flash_fwd(_kernel_chunks(q, devices),
                                    _kernel_chunks(k, devices),
                                    _kernel_chunks(v, devices), ring, scale,
                                    causal)
        out = _global(os_, q.device)
        lse = col.unshard(lses, 2, q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.devices, ctx.ring = devices, ring
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        devices = ctx.devices
        chunks = [_kernel_chunks(x, devices) for x in (q, k, v, out)]
        dqs, dks, dvs = _ring_flash_bwd(
            *chunks, col.shard(lse, devices, 2),
            _kernel_chunks(dout.to(q.dtype), devices), ctx.ring, ctx.scale,
            ctx.causal)
        return (_global(dqs, q.device), _global(dks, k.device),
                _global(dvs, v.device), None, None, None, None)


def _check_flash_chunk(sc: int, d: int) -> None:
    """The gate of ``ops.attention._flash_supported``, on one ring chunk."""
    if not (sc >= 256 and sc % 128 == 0 and d in (64, 128, 256)):
        raise ValueError(
            f"ring_attention impl='flash': a chunk of {sc} tokens at head_dim "
            f"{d} is not one the flash kernels take (at least 256 tokens, a "
            "multiple of 128; head_dim 64, 128 or 256); use "
            "impl='reference'")


def _join(parts: list, dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def ring_attention(q, k, v, *, mesh, axis: str = "sp", causal: bool = True,
                   scale: float | None = None, batch_axes=("dp", "fsdp"),
                   head_axis: str = "tp", impl: str = "auto",
                   block_q: int = 512, block_k: int = 1024):
    """Exact attention with the sequence axis cut over ``axis`` of
    ``mesh``.

    q [batch, seq, heads, head_dim], k and v [batch, seq, kv_heads,
    head_dim]: global tensors. Returns the global output [batch, seq,
    heads, head_dim] on q's device. The batch is split over
    ``batch_axes`` and the heads over ``head_axis`` when they are on the
    mesh, wider than one and divide: those are independent rings, one per
    index of those axes, each over the devices along ``axis`` there (at
    index 0 of any other axis, whose work JAX replicates).
    ``block_q``/``block_k`` are TPU tiling arguments, kept in the
    signature and ignored: the kernels pick their own tiles.

    When ``axis`` spans processes (module docstring), q, k and v are this
    process's block (its chunk of the sequence) and the output is its
    block; its ring ranks, and the rings of its other places, run
    together.
    """
    del block_q, block_k
    if mesh is None:
        raise ValueError("ring_attention requires mesh=")
    b, s, h, d = q.shape
    hk = k.shape[2]
    n = mesh.shape[axis]
    scale = scale if scale is not None else d ** -0.5
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(
            f"ring_attention impl must be 'auto', 'flash' or 'reference', "
            f"got {impl!r}")
    use_flash = impl == "flash" or (impl == "auto" and q.is_cuda)
    if mesh.spans(axis):
        devices = mesh.axis_devices(axis)
        if s % len(devices):
            raise ValueError(f"seq {s} not divisible by this process's "
                             f"{len(devices)} {axis} ranks")
        ring = _Ring(n, len(devices), mesh.group(axis), mesh.offset(axis))
        if use_flash:
            _check_flash_chunk(s // len(devices), d)
            return _RingFlash.apply(q, k, v, devices, ring, scale, causal)
        qs, ks, vs = (col.shard(x, devices, 1) for x in (q, k, v))
        return col.unshard(_ring_reference(qs, ks, vs, ring, scale, causal),
                           1, q.device)
    if s % n:
        raise ValueError(f"seq {s} not divisible by {axis} size {n}")

    b_ax = tuple(a for a in batch_axes
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    if b_ax and b % math.prod(mesh.shape[a] for a in b_ax):
        b_ax = ()
    h_ax = (head_axis
            if head_axis in mesh.axis_names and mesh.shape[head_axis] > 1
            and h % mesh.shape[head_axis] == 0
            and hk % mesh.shape[head_axis] == 0 else None)

    if use_flash:
        _check_flash_chunk(s // n, d)

    def body(qh, kh, vh, devices):
        if use_flash:
            return _RingFlash.apply(qh, kh, vh, devices, _Ring(n), scale,
                                    causal)
        qs, ks, vs = (col.shard(x, devices, 1) for x in (qh, kh, vh))
        return col.unshard(_ring_reference(qs, ks, vs, _Ring(n), scale,
                                           causal), 1, qh.device)

    b_sizes = [mesh.shape[a] for a in b_ax]
    nb = math.prod(b_sizes)
    nh = mesh.shape[h_ax] if h_ax else 1
    rows = []
    for b_index, qb, kb, vb in zip(
            itertools.product(*(range(m) for m in b_sizes)),
            q.chunk(nb, 0), k.chunk(nb, 0), v.chunk(nb, 0)):
        at = dict(zip(b_ax, b_index))
        heads = []
        for h_index, qh, kh, vh in zip(range(nh), qb.chunk(nh, 2),
                                       kb.chunk(nh, 2), vb.chunk(nh, 2)):
            if h_ax:
                at[h_ax] = h_index
            heads.append(body(qh, kh, vh, mesh.axis_devices(axis, at)))
        rows.append(_join(heads, 2))
    return _join(rows, 0)
