"""On-device world simulation (doc/simulation.md).

A server-driven NPC population stepped on the accelerator INSIDE the
same guarded spatial tick: agents occupy ordinary entity slots in the
engine's arrays, so crossings, handover, adaptive partitioning,
standing queries and device fan-out see them exactly like human-driven
entities — with zero additional device<->host transfers per tick (the
sim pass is device->device; the only readback is the census-cadence
batched fetch that rides the guarded step's existing prefetch window).

Authority flows through an internal server connection
(:mod:`.authority`): the sim plane registers as an ordinary spatial
server peer and commits census batches through the ordinary channel
path, never by poking channel state directly.
"""

from .plane import SimPlane, reset_sim, restore_census  # noqa: F401

__all__ = ["SimPlane", "reset_sim", "restore_census"]
