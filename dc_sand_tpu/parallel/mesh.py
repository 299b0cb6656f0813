"""Device-mesh construction (C13).

One logical axis ``fx`` covers the standard deployment: antenna-sharded
F-engines before the corner-turn, channel-sharded X/B-engines after — the
same devices play both roles (colocated F/X, SURVEY.md §2.3 PP row).  An
optional ``time`` axis enables stream (sequence-parallel) sharding with
halo exchange.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

FX_AXIS = "fx"
TIME_AXIS = "time"

__all__ = ["build_mesh", "FX_AXIS", "TIME_AXIS"]


def build_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None,
               time_shards: int = 1, time_local: bool = False) -> Mesh:
    """Build a ``(time, fx)`` mesh over the given devices.

    ``time_shards=1`` (default) gives the pure FX layout; >1 additionally
    shards the sample stream (halo exchange becomes active).  ``devices``
    defaults to ``jax.devices()`` (after ``jax.distributed.initialize()``
    that is every device of every process); asking for more devices than
    exist raises — the mesh is never silently built elsewhere or smaller.

    ``time_local=True`` lays the TIME axis out within each process's
    contiguous device block (fx across processes, time across each
    process's local devices) — the ingest-locality layout the
    multi-process SP streaming runner requires: one host receives its
    antennas' whole contiguous stream and its local devices split it in
    time, so the overlap-save halo never leaves the host.  The default
    (time-major) layout spreads each time shard across all processes —
    right for model-level SP tests, unusable for a streaming feed."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)} "
                f"({devices[0].platform})")
        devices = devices[:n_devices]
    n = len(devices)
    if n % time_shards:
        raise ValueError(f"{n} devices not divisible by {time_shards} "
                         "time shards")
    if time_local:
        arr = np.asarray(devices).reshape(n // time_shards, time_shards).T
    else:
        arr = np.asarray(devices).reshape(time_shards, n // time_shards)
    return Mesh(arr, (TIME_AXIS, FX_AXIS))
