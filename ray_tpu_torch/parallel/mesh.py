"""Device meshes and their registry, single-controller as in the JAX
package.

Port of ``ray_tpu/parallel/mesh.py``. The JAX package runs one process
that holds global arrays, and ``shard_map`` runs a body per device of a
``jax.sharding.Mesh``. The port keeps that model: ``Mesh`` is a named grid
of ``torch.device``s, its axes in ``AXIS_ORDER``, and one Python process
drives every place of it. A body that runs per rank sees the ranks' chunks
as one list in mesh order, and the device-plane collectives
(``parallel.collectives``) map such lists to lists, moving each result to
its rank's device.

The same card may fill several places of a mesh: on one H100 a ring of
four is ``create_mesh({"sp": 4}, devices=[card] * 4)``, and its "transfers"
between ranks are no-ops. On a machine with several cards the same code
runs across them, each transfer a peer copy. One thread per rank with a
rendezvous fails (``torch.autograd`` runs the backward of a device's
tensors on one engine thread, so a ring backward that waits for another
rank's backward deadlocks).

**Across processes.** One process per rank over ``torch.distributed``,
the counterpart of ``jax.distributed.initialize``
(``ray_tpu/train/worker_group.py``), comes with the port's training
harness (``parallel.process_group``). Then the global mesh's places are
dealt to the ``world`` processes as JAX deals them: its mesh is
row-major over ``jax.devices()``, which are ordered by process
(``ray_tpu/parallel/mesh.py``), so in row-major ``AXIS_ORDER`` rank ``p``
owns places ``[p·n/world, (p+1)·n/world)`` of the ``n``, an equal
contiguous block (``split_axes``). The axes before the one where the
process boundary falls are spanned one index a process; that axis is
*cut*: each process holds ``k`` consecutive indices of its ``n`` and
``n/k`` processes span it (``k = 1``: spanned wholly); the axes after it
lie wholly inside each process. On ``{fsdp 2, tp 2}``, world 4 gives one
place a process and world 2 lets fsdp span the processes while each
drives its two tp places; ``{tp 4}`` at world 2 gives each process tp
indices ``[2p, 2p + 2)``. ``pp`` across processes runs each process's
own stages of the 1F1B schedule, activations and gradients moving
between processes by point-to-point sends (``parallel.pipeline``); ``ep``
across processes runs each process's own experts, their inputs summed
from every data process and their outputs gathered to every one
(``train.spmd``). A block that is not such a grid, or a mesh that does
not divide into equal blocks, raises before any process starts.

Such a process's ``Mesh`` carries a ``ProcessLayout``: ``shape`` and
``size`` are the global mesh's, ``devices`` (and ``local_shape``) the
grid of this process's places, ``offset(axis)`` the global index of its
first place along an axis, and ``group(axis)`` this process's line of a
spanned axis, the subgroup of the processes along it
(``process_group.AxisGroup``; every process makes the subgroup of every
line, in one order, as ``dist.new_group`` requires). The rank-list
collectives then take the list of this process's ``k`` chunks along an
axis and, with ``group=``, run on the subgroup as well: global index
``offset + i`` for local chunk ``i``. A rank's device is
``process_group.rank_device``: on one card every rank is on it, over
gloo (NCCL refuses two ranks on one GPU). A mesh of one process has no
layout and is the mesh above, unchanged.

Axis convention, outer to inner (slowest to fastest varying):

    pp   - pipeline stages
    dp   - pure data parallelism
    fsdp - sharded data parallelism (parameters, gradients, optimizer)
    ep   - expert parallelism for MoE
    sp   - sequence/context parallelism (ring and Ulysses attention)
    tp   - tensor/model parallelism

Devices are assigned row-major, as the JAX package assigns them off a
TPU; there is no torus to map onto.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

# Canonical axis order, outer to inner. Meshes may use any subset.
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name -> size. Size -1 means "absorb all
    remaining devices" (at most one axis may be -1)."""

    axes: dict[str, int] = field(default_factory=dict)

    def resolved(self, n_devices: int) -> dict[str, int]:
        axes = dict(self.axes)
        wild = [k for k, v in axes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one axis may be -1, got {wild}")
        fixed = math.prod(v for v in axes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {axes}"
                )
            axes[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"Mesh axes {axes} require {fixed} devices, have {n_devices}"
                )
        # order axes canonically; unknown axes go last in given order
        known = [a for a in AXIS_ORDER if a in axes]
        extra = [a for a in axes if a not in AXIS_ORDER]
        return {a: axes[a] for a in known + extra}


def _ordered(axes: dict) -> list:
    known = [a for a in AXIS_ORDER if a in axes]
    return known + [a for a in axes if a not in AXIS_ORDER]


def split_axes(axes: dict, world: int) -> tuple[dict, dict]:
    """The global mesh ``axes`` dealt to ``world`` processes (module
    docstring): (this process's local axes, the number of processes along
    each spanned axis). An axis cut at the process boundary is in both:
    ``k`` local indices, ``n/k`` processes. ``dp=-1`` takes one index a
    process; any other -1 axis size 1. Raises before any process starts
    where the places do not divide into equal blocks (JAX gives every
    process the same number of devices) or a block is not a grid of
    whole lines past the cut."""
    axes = {a: (world if a == "dp" else 1) if n == -1 else n
            for a, n in axes.items()}
    if world == 1:
        return axes, {}
    total = math.prod(axes.values())
    if total % world:
        raise ValueError(f"{world} processes for the {total} places of "
                         f"{axes}: JAX deals every process an equal block "
                         "of the mesh")
    local, procs, left = {}, {}, world
    for a in _ordered(axes):
        n = axes[a]
        if left == 1 or n == 1:
            local[a] = n
        elif left % n == 0:
            procs[a], local[a] = n, 1
            left //= n
        elif n % left == 0:
            procs[a], local[a] = left, n // left
            left = 1
        else:
            raise NotImplementedError(
                f"axis {a!r} of size {n} in {axes} meets {left} processes: "
                f"a block of {total // world} places would hold part of a "
                "line of it at one index of the axes before it; the port "
                "deals each process a grid, the axis where the process "
                "boundary falls cut into equal runs of consecutive indices")
    return local, procs


@dataclass(frozen=True)
class ProcessLayout:
    """This process's part of a global mesh (``split_axes``): ``local``
    axes (``k`` indices of a cut axis), ``procs`` (processes along each
    spanned axis), ``index`` (this process's index along each),
    ``groups`` (its ``process_group.AxisGroup`` on each)."""

    rank: int
    world: int
    local: dict
    procs: dict
    index: dict
    groups: dict

    def restrict(self, names) -> "ProcessLayout":
        keep = [a for a in names if a in self.procs]
        return ProcessLayout(self.rank, self.world,
                             {a: self.local[a] for a in names},
                             {a: self.procs[a] for a in keep},
                             {a: self.index[a] for a in keep},
                             {a: self.groups[a] for a in keep
                              if a in self.groups})


class Mesh:
    """A named grid of ``torch.device``s (``devices``: an object array
    whose dimensions are the axes ``axis_names``). ``shape`` maps each
    axis to its size, as ``jax.sharding.Mesh.shape`` does. With a
    ``layout`` (module docstring) ``devices`` holds this process's places
    only, and ``shape`` and ``size`` are the global mesh's."""

    def __init__(self, devices: np.ndarray, axis_names: tuple,
                 layout: ProcessLayout | None = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.layout = layout if layout is not None and layout.procs \
            else None

    @property
    def local_shape(self) -> dict[str, int]:
        """The grid of this process's places."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def shape(self) -> dict[str, int]:
        procs = self.layout.procs if self.layout else {}
        return {a: n * procs.get(a, 1)
                for a, n in zip(self.axis_names, self.devices.shape)}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def spans(self, axis: str) -> bool:
        """Whether the places along ``axis`` lie in several processes."""
        return self.layout is not None and axis in self.layout.procs

    @property
    def spanned(self) -> tuple:
        return tuple(self.layout.procs) if self.layout else ()

    def group(self, axis: str):
        """This process's line of the spanned ``axis``
        (``process_group.AxisGroup``)."""
        return self.layout.groups[axis]

    def offset(self, axis: str) -> int:
        """The global index along ``axis`` of this process's first place
        (its process index times its ``k`` local indices)."""
        if not self.spans(axis):
            return 0
        return self.layout.index[axis] * self.local_shape[axis]

    def global_coords(self, coords: tuple) -> tuple:
        """The global coordinates of the local place at ``coords``."""
        return tuple(c + self.offset(a)
                     for a, c in zip(self.axis_names, coords))

    def local(self) -> "Mesh":
        """This process's places as a mesh of their own (no layout)."""
        return Mesh(self.devices, self.axis_names)

    def line(self, axis: str, at: dict | None = None) -> "Mesh":
        """The one-axis mesh of the places along ``axis`` at the local
        index ``at`` of the other axes, spanning processes where ``axis``
        does (its ``offset`` the global index of its first place)."""
        devs = self.axis_devices(axis, at)
        grid = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            grid[i] = d
        return Mesh(grid, (axis,), self.layout.restrict((axis,))
                    if self.layout else None)

    def axis_devices(self, axis: str, at: dict | None = None) -> list:
        """The devices along ``axis``, in order, at the index ``at[name]``
        of every other axis (0 where ``at`` names none): the ranks of one
        ring (this process's places only, at local indices; the first at
        global index ``offset(axis)``)."""
        at = at or {}
        index = tuple(slice(None) if name == axis else at.get(name, 0)
                      for name in self.axis_names)
        return list(self.devices[index])

    def __repr__(self) -> str:
        procs = f", processes={self.layout.procs}" if self.layout else ""
        return (f"Mesh({self.shape}, devices="
                f"{self.devices.ravel().tolist()}{procs})")


def _device_grid(devices, shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    for i, dev in enumerate(devices):
        grid[i] = torch.device(dev)
    return grid.reshape(shape)


def visible_devices() -> list:
    """Every CUDA card this process sees (none on a host without one)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(axes: dict[str, int] | MeshSpec, *, devices=None) -> Mesh:
    """A Mesh over ``devices`` (default: every visible card) with row-major
    assignment. ``axes`` maps axis name -> size; one axis may be -1 (the
    remaining devices). A device may appear more than once: one card can
    hold every rank of a ring."""
    if devices is None:
        devices = visible_devices()
    spec = axes if isinstance(axes, MeshSpec) else MeshSpec(dict(axes))
    resolved = spec.resolved(len(devices))
    return Mesh(_device_grid(devices, tuple(resolved.values())),
                tuple(resolved.keys()))


def create_hybrid_mesh(ici_axes: dict[str, int], dcn_axes: dict[str, int], *,
                       devices=None) -> Mesh:
    """Multi-slice mesh: ``dcn_axes`` (outermost; across slices in the JAX
    package) x ``ici_axes`` (within a slice). On one machine the DCN axes
    are simply the outer axes."""
    if devices is None:
        devices = visible_devices()
    if not devices:
        raise ValueError("create_hybrid_mesh: no devices")
    n = len(devices)
    dcn_shape = tuple(dcn_axes.values())
    n_slices = math.prod(dcn_shape)
    if n % n_slices != 0:
        raise ValueError(
            f"{n} devices not divisible by dcn axes {dcn_axes} "
            f"({n_slices} slices)"
        )
    per_slice = n // n_slices
    ici_resolved = MeshSpec(dict(ici_axes)).resolved(per_slice)
    names = tuple(dcn_axes.keys()) + tuple(ici_resolved.keys())
    return Mesh(_device_grid(devices,
                             dcn_shape + tuple(ici_resolved.values())), names)


class MeshRegistry:
    """Named meshes (the JAX package's registry, keyed as the reference's
    collective ``GroupManager`` keys its groups)."""

    def __init__(self):
        self._meshes: dict[str, Mesh] = {}
        self._lock = threading.Lock()

    def register(self, name: str, mesh: Mesh, *, overwrite: bool = False):
        with self._lock:
            return self._register_locked(name, mesh, overwrite)

    def _register_locked(self, name: str, mesh: Mesh, overwrite: bool):
        if name in self._meshes and not overwrite:
            raise ValueError(f"Mesh {name!r} already registered")
        self._meshes[name] = mesh
        return mesh

    def get(self, name: str) -> Mesh:
        with self._lock:
            if name not in self._meshes:
                raise KeyError(
                    f"No mesh named {name!r}; registered: {list(self._meshes)}"
                )
            return self._meshes[name]

    def get_or_create(self, name: str, axes: dict[str, int], **kwargs) -> Mesh:
        # one critical section: a concurrent creator gets the winner's mesh
        # back, not a ValueError from a lost register race
        with self._lock:
            if name in self._meshes:
                return self._meshes[name]
            mesh = create_mesh(axes, **kwargs)
            return self._register_locked(name, mesh, overwrite=False)

    def remove(self, name: str):
        with self._lock:
            self._meshes.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._meshes)


_registry = MeshRegistry()


def mesh_registry() -> MeshRegistry:
    return _registry


def slice_topology() -> dict:
    """Describe the cards this process sees: platform, count, hosts (one:
    the port runs in one process) and each card's name."""
    devices = visible_devices()
    info = {"platform": "cuda" if devices else "none",
            "num_devices": len(devices),
            "num_hosts": 1 if devices else 0}
    if devices:
        info["device_kind"] = [torch.cuda.get_device_name(d)
                               for d in devices]
    return info
