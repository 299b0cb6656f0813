"""Collective microbenchmarks (C15).

The mirror of the reference's NVLink/PCIe/GPUDirect bandwidth
experiments (SURVEY.md §2.1 "Transport experiments"): measure what the
interconnect actually delivers for the collectives the pipeline uses —
``all_to_all`` (corner-turn), ``ppermute`` (halo exchange), ``psum`` /
``psum_scatter`` (replicated / EP beam reduction) — per message size,
per mesh.  On a GPU mesh XLA runs them through NCCL.

On several devices these numbers are the corner-turn capacity check; on
a single device they degenerate to self-copies and on a CPU mesh they
measure host memory — both still exercise the code path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dc_sand_tpu.bench.harness import BenchResult, time_throughput
from dc_sand_tpu.parallel import FX_AXIS

__all__ = ["bench_collective", "COLLECTIVES"]

COLLECTIVES = ("all_to_all", "ppermute", "psum", "psum_scatter",
               "all_gather")


def bench_collective(op: str, mesh, *, mb_per_chip: float = 16.0,
                     iters: int = 32) -> BenchResult:
    """Measure achieved per-device bandwidth of one collective over
    ``mesh``'s fx axis.  Bytes accounting is the wire traffic per device
    (payload leaving/entering each device), not the array size."""
    d = mesh.shape[FX_AXIS]
    n_rows = max(d, int(mb_per_chip * 1e6 / (4 * 1024)))
    n_rows -= n_rows % d
    local_bytes = n_rows * 1024 * 4

    if op == "all_to_all":
        def fn(x):
            return jax.lax.all_to_all(x, FX_AXIS, split_axis=0,
                                      concat_axis=0, tiled=True)
        wire = local_bytes * (d - 1) / d
    elif op == "ppermute":
        perm = [(i, (i + 1) % d) for i in range(d)]

        def fn(x):
            return jax.lax.ppermute(x, FX_AXIS, perm)
        wire = local_bytes
    elif op == "psum":
        def fn(x):
            return jax.lax.psum(x, FX_AXIS)
        wire = local_bytes * 2 * (d - 1) / d  # reduce-scatter + all-gather
    elif op == "psum_scatter":
        # the EP beam reduction (cfg.beam_parallel): half a psum's wire
        def fn(x):
            return jax.lax.psum_scatter(x, FX_AXIS, scatter_dimension=0,
                                        tiled=True)
        wire = local_bytes * (d - 1) / d
    elif op == "all_gather":
        def fn(x):
            return jax.lax.all_gather(x, FX_AXIS, tiled=True)
        wire = local_bytes * (d - 1)
    else:
        raise ValueError(f"unknown collective {op!r}; "
                         f"available: {COLLECTIVES}")

    sharded = jax.shard_map(fn, mesh=mesh, in_specs=P(FX_AXIS),
                            out_specs=P() if op == "psum" else P(FX_AXIS))
    with jax.default_device(mesh.devices.flat[0]):
        x = jnp.zeros((n_rows * d, 1024), jnp.float32)
    wall = time_throughput(sharded, (x,), iters=iters)
    return BenchResult(
        name=f"collective_{op}_{d}dev",
        metric=f"{op} per-device bandwidth", value=wire / wall / 1e9,
        unit="GB/s", wall_s=wall, bytes_moved=wire,
        extra={"devices": d, "local_mb": local_bytes / 1e6,
               "platform": mesh.devices.flat[0].platform},
    ).finish()
