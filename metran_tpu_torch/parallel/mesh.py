"""Device meshes: named grids of ``torch.device``s and the shardings that
split a tensor over them.

Port of ``metran_tpu/parallel/mesh.py``.  The JAX package shards from one
process with ``shard_map`` and ``NamedSharding`` over a ``jax.sharding.
Mesh``; the port keeps that shape with one controller: a :class:`Mesh` is
a named grid of devices, a sharded call places each shard on its device
and launches that shard's kernels there, and the only cross-device
traffic is what the JAX code gathers (one scan element per shard, one
model's row), moved by ``.to(device)`` — a peer copy between distinct
cards, a no-op on a virtual mesh whose devices are one device.

The devices come from :func:`metran_tpu_torch.config.mesh_devices`: every
CUDA card, or the CPU, each repeated ``METRAN_TPU_VIRTUAL_DEVICES``
times (the counterpart of XLA's host device count).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import mesh_devices

BATCH_AXIS = "batch"


class Mesh:
    """A named grid of devices (the port's ``jax.sharding.Mesh``):
    ``devices`` an object array of ``torch.device``s whose dimensions are
    named by ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a {self.devices.ndim}-D device grid needs as many axis "
                f"names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        """``{axis name: size}`` (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        """Every device of the grid, in row-major order."""
        return list(self.devices.flat)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis): where
        the shards of a split over ``axis`` live, each computed once."""
        if axis not in self.axis_names:
            raise KeyError(f"mesh has no axis {axis!r} (axes "
                           f"{self.axis_names})")
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[pos] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.flat_devices()})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (BATCH_AXIS,),
    devices=None,
) -> Mesh:
    """Build a device mesh for fleet or sequence sharding.

    Parameters
    ----------
    n_devices : total number of devices to use (default: all available).
    axis_names : mesh axis names; 1D ``("batch",)`` by default.  For a 2D
        mesh pass e.g. ``("batch", "series")`` — the device count must
        factorize, the batch axis gets the larger factor.
    devices : explicit device list (default :func:`~metran_tpu_torch.
        config.mesh_devices` of the card, which raises without one; on
        the CPU pass ``mesh_devices("cpu")``).
    """
    if devices is None:
        devices = mesh_devices()
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    n_devices = int(n_devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(
            f"a mesh of {n_devices} devices needs that many; "
            f"{len(devices)} available (METRAN_TPU_VIRTUAL_DEVICES repeats "
            "each device for a virtual mesh)")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    if len(axis_names) == 1:
        shape = (n_devices,)
    elif len(axis_names) == 2:
        minor = _largest_minor_factor(n_devices)
        shape = (n_devices // minor, minor)
    else:
        raise ValueError("make_mesh supports 1D or 2D meshes")
    return Mesh(grid.reshape(shape), axis_names)


def _largest_minor_factor(n: int, cap: int = 4) -> int:
    """Largest factor of n that is <= min(cap, sqrt(n)), so the minor axis
    never exceeds the leading (batch) axis."""
    cap = min(cap, int(np.sqrt(n)))
    for f in range(max(cap, 1), 0, -1):
        if n % f == 0:
            return f
    return 1


class Sharding:
    """How a tensor lies on a mesh: dimension ``dim`` split evenly over
    mesh axis ``axis`` (its pieces on the devices along that axis), or,
    with ``axis=None``, one copy on every device of the mesh."""

    def __init__(self, mesh: Mesh, ndim: Optional[int] = None,
                 axis: Optional[str] = None, dim: int = 0):
        self.mesh = mesh
        self.ndim = ndim
        self.axis = axis
        self.dim = int(dim)
        self.devices = (mesh.flat_devices() if axis is None
                        else mesh.axis_devices(axis))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The pieces of ``x``, each on its device."""
        if self.axis is None:
            return [x.to(d) for d in self.devices]
        if self.ndim is not None and x.dim() != self.ndim:
            raise ValueError(f"sharding is for {self.ndim}-D tensors, got "
                             f"{tuple(x.shape)}")
        parts = len(self.devices)
        if x.shape[self.dim] % parts:
            raise ValueError(
                f"dimension {self.dim} ({x.shape[self.dim]}) must be "
                f"divisible by mesh axis {self.axis!r} ({parts})")
        return [p.to(d) for p, d in
                zip(torch.chunk(x, parts, dim=self.dim), self.devices)]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        first = self.devices[0]
        if self.axis is None:
            return parts[0].to(first)
        return torch.cat([p.to(first) for p in parts], dim=self.dim)


def batch_sharding(mesh: Mesh, ndim: int, axis: str = BATCH_AXIS,
                   dim: int = 0) -> Sharding:
    """Sharding that splits tensor dimension ``dim`` (the fleet axis) over
    mesh axis ``axis``."""
    return Sharding(mesh, ndim, axis, dim)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (fleet padding for even shards)."""
    return ((n + m - 1) // m) * m


__all__ = [
    "BATCH_AXIS",
    "Mesh",
    "Sharding",
    "batch_sharding",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
]
