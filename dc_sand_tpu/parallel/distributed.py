"""Multi-process SPMD entry (C15).

With several processes every one runs the same program: call
``init_distributed(coordinator, num_processes, process_id)`` first, then
build the mesh over ``jax.devices()`` (all devices of all processes);
XLA routes the collectives over NCCL (BASELINE.json:5).  The streaming
runner then feeds each process only its local antennas' packets
(``local_antenna_range``).

The multi-process path is validated by the CPU-mesh tests
(``tests/test_distributed.py`` spawns CPU workers) and
``dryrun_multichip``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

__all__ = ["init_distributed", "local_antenna_range"]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> dict:
    """Initialise jax.distributed (no-op when single-process).

    Nothing tells JAX of a cluster on its own: pass the coordinator
    address (e.g. ``"localhost:8476"``), the process count and this
    process's id.  With no arguments this is the single-process no-op.
    """
    if num_processes is not None and num_processes > 1 or coordinator:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def local_antenna_range(n_ants: int) -> Tuple[int, int]:
    """[start, stop) antennas this host ingests: the antenna axis is
    sharded contiguously over processes, matching the mesh layout built
    from ``jax.devices()`` (process-major device order)."""
    p, n = jax.process_index(), jax.process_count()
    if n_ants % n:
        raise ValueError(f"{n_ants} antennas not divisible over {n} hosts")
    per = n_ants // n
    return p * per, (p + 1) * per
