"""One controller over a list of devices: the port's ``Mesh``, its
``shard_map`` and the four collectives the sharded steps use.

The counterpart of ``channeld_tpu/parallel/_jax_compat.py`` and of the
JAX features it wraps. The JAX package is single-controller: one
process owns the ``Mesh``, its ``shard_map`` body runs once per device,
and ``psum``, ``all_gather``, ``all_to_all`` and ``ppermute`` move data
between devices inside that process. The port keeps that shape without
``torch.distributed`` (which would need a process per rank, and refuses
two ranks on one card):

- ``Mesh`` is an ordered list of ``torch.device``s, which may repeat,
  with its shape and axis names. Position ``i`` of the list is shard
  ``i``: row-major, so ``shard_index(coords) == Σ axis_index · Π later
  sizes``, as ``mesh.py`` computes it inside the JAX step. A mesh whose
  shards share one device is the port's analogue of XLA's
  ``--xla_force_host_platform_device_count``: eight shards on ``cpu``
  in the tests, eight on one card in ``chip_smoke.py``.
- ``run_shards`` is ``shard_map``: a plain loop over the shards, in
  shard order, running the body with that shard's device current, so a
  CUDA kernel launches on that card's current stream.
- The collectives are explicit tensor moves in a fixed order:
  ``psum`` sums the shards' parts in shard order on one device,
  ``all_gather`` stacks (or concatenates) them there, ``all_to_all``
  hands shard ``d`` the ``d``-th bucket of every source in source
  order, and ``ppermute`` shifts a list around the ring.

Nothing here adds a feature the JAX package lacks. Unlike JAX's
``Mesh``, this one accepts repeated devices.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence, Union

import torch


class Mesh:
    """An ordered list of devices with a shape and axis names."""

    def __init__(self, devices: Sequence, shape: Sequence[int], axis_names: Sequence[str]):
        devices = tuple(torch.device(d) for d in devices)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axis names {tuple(axis_names)}")
        if not devices or math.prod(shape) != len(devices):
            raise ValueError(f"{len(devices)} devices do not fill a mesh of shape {shape}")
        self.devices = devices
        self.shape = shape
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def replica(self) -> torch.device:
        """Where replicated values live: the first shard's device."""
        return self.devices[0]

    def coords(self, shard: int) -> tuple[int, ...]:
        """The axis indices of shard ``shard`` (row-major)."""
        out = []
        for size in reversed(self.shape):
            out.append(shard % size)
            shard //= size
        return tuple(reversed(out))

    def shard_index(self, coords: Sequence[int]) -> int:
        """``Σ axis_index · Π later sizes`` (``parallel/mesh.py``'s
        ``shard_index``): the position of ``coords`` in the list."""
        index = 0
        for size, i in zip(self.shape, coords):
            index = index * size + int(i)
        return index

    def __repr__(self) -> str:
        axes = ", ".join(f"'{a}': {s}" for a, s in zip(self.axis_names, self.shape))
        return f"Mesh({axes}; {', '.join(str(d) for d in self.devices)})"


def on_device(device: torch.device):
    """``device`` as the current CUDA device (nothing to do on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_shards(mesh: Mesh, body: Callable[[int], object]) -> list:
    """``shard_map``: ``[body(0), ..., body(S - 1)]``, each with its
    shard's device current."""
    out = []
    for shard, device in enumerate(mesh.devices):
        with on_device(device):
            out.append(body(shard))
    return out


def shard(mesh: Mesh, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> list[torch.Tensor]:
    """Per-shard parts of an entity array: a list of parts is checked and
    returned as is; a global tensor is split along dim 0 into equal
    contiguous blocks, each moved to its shard's device (a view where the
    device does not change)."""
    if isinstance(x, torch.Tensor):
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} shards")
        return [p.to(d) for p, d in zip(torch.chunk(x, mesh.size), mesh.devices)]
    parts = list(x)
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    return parts


def unshard(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The global array of per-shard parts, on ``device`` (the first
    part's by default)."""
    device = parts[0].device if device is None else device
    return torch.cat([p.to(device) for p in parts])


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' parts summed in shard order on ``device``."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def all_gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' parts stacked along a new ``dim`` on ``device``
    (``tiled=False``)."""
    return torch.stack([p.to(device) for p in parts], dim)


def all_to_all(mesh: Mesh, buckets: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``all_to_all(x, axis, 0, 0, tiled=False)``: ``buckets[s]`` is
    source shard ``s``'s ``[S, ...]`` array; shard ``d`` receives
    ``[S, ...]`` holding ``buckets[s][d]`` for every source ``s``, in
    source order, on its own device."""
    return [torch.stack([b[d].to(dev) for b in buckets])
            for d, dev in enumerate(mesh.devices)]


def ppermute(mesh: Mesh, parts: Sequence[torch.Tensor], shift: int) -> list[torch.Tensor]:
    """The ring shift ``[(i, (i + shift) % S)]``: shard ``(i + shift) % S``
    receives shard ``i``'s part on its own device."""
    n = mesh.size
    out: list = [None] * n
    for i, part in enumerate(parts):
        j = (i + shift) % n
        out[j] = part.to(mesh.devices[j])
    return out
