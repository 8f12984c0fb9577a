"""Device pick for every entry point of the port.

The JAX package pins its backend to the CPU for tests
(``channeld_tpu/utils/devices.py``); the port instead runs on the card
unless the caller explicitly asks for the CPU, and never falls back to
the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` when ``device`` is None; ``"cpu"`` only when asked for.

    Raises RuntimeError when CUDA is wanted (explicitly or by default)
    and no CUDA device is present, and ValueError for any other device
    type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def mesh_devices(n: int, device: Optional[Union[str, torch.device]] = None) -> list[torch.device]:
    """The devices of an ``n``-shard mesh on ``device``'s kind (``cuda``
    when None, as ``resolve_device``): on the CPU, ``n`` shards on
    ``cpu`` (the port's counterpart of XLA's virtual host devices); on
    CUDA, the first ``n`` cards, and ValueError when fewer are present.
    Never spreads shards over fewer cards on its own: a mesh with
    repeated devices is built explicitly with ``parallel.mesh.make_mesh``."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    present = torch.cuda.device_count()
    if present < n:
        raise ValueError(f"mesh wants {n} devices but only {present} present")
    return [torch.device("cuda", i) for i in range(n)]
