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
runs across them, each transfer a peer copy. Two other designs fail on one
card: one process per rank over NCCL (NCCL refuses two ranks on one GPU),
and one thread per rank with a rendezvous (``torch.autograd`` runs the
backward of a device's tensors on one engine thread, so a ring backward
that waits for another rank's backward deadlocks). One process per rank
over ``torch.distributed``, the counterpart of
``jax.distributed.initialize`` (``ray_tpu/train/worker_group.py``), comes
with the port's multi-process training harness.

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


class Mesh:
    """A named grid of ``torch.device``s (``devices``: an object array
    whose dimensions are the axes ``axis_names``). ``shape`` maps each
    axis to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str, at: dict | None = None) -> list:
        """The devices along ``axis``, in order, at the index ``at[name]``
        of every other axis (0 where ``at`` names none): the ranks of one
        ring."""
        at = at or {}
        index = tuple(slice(None) if name == axis else at.get(name, 0)
                      for name in self.axis_names)
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


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
