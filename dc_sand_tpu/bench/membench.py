"""Device memory-bandwidth microbenchmarks.

The mirror of dc_sand's NVLink/PCIe/membench experiments
(SURVEY.md §2.1): measure what HBM actually delivers for the access
patterns the pipeline uses — streaming copy, triad, int8 read->fp32
write (the F-engine's input conversion), and transpose (the local
corner-turn) — so roofline fractions in the other benchmarks rest on a
measured, not quoted, ceiling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dc_sand_tpu.bench.harness import BenchResult, time_throughput

__all__ = ["bench_membench", "PATTERNS"]

PATTERNS = ("copy", "triad", "int8_upcast", "transpose")


def bench_membench(pattern: str, *, mb: float = 256.0,
                   iters: int = 64) -> BenchResult:
    n = int(mb * 1e6 / 4)
    n -= n % (8 * 128)
    if pattern == "copy":
        # NB: v * 1.0 gets elided to an alias (no traffic at all); a
        # non-identity multiplier forces the traffic
        x = jax.jit(lambda: jnp.ones((n,), jnp.float32))()
        fn = lambda v: v * 1.0000001  # noqa: E731
        bytes_moved = 2 * n * 4
    elif pattern == "triad":
        x = jax.jit(lambda: jnp.ones((n,), jnp.float32))()
        fn = lambda v: v * 2.0 + 1.0  # noqa: E731
        bytes_moved = 2 * n * 4
    elif pattern == "int8_upcast":
        x = jax.jit(lambda: jnp.ones((4 * n,), jnp.int8))()
        fn = lambda v: v.astype(jnp.float32) * 0.5  # noqa: E731
        bytes_moved = 4 * n * 1 + 4 * n * 4
    elif pattern == "transpose":
        # v.T alone is a layout annotation (no data moves); summing the
        # two orientations forces a real relayout read.  Honour the mb
        # working-set knob like the 1-D patterns (largest tile-aligned
        # square side with side^2 fp32 <= mb)
        side = int((mb * 1e6 / 4) ** 0.5)
        side -= side % 1024
        side = max(side, 1024)
        x = jax.jit(lambda: jnp.ones((side, side), jnp.float32))()
        fn = lambda v: v.T + v  # noqa: E731
        bytes_moved = 3 * side * side * 4
    else:
        raise ValueError(f"unknown pattern {pattern!r}; choose {PATTERNS}")
    x = jax.block_until_ready(x)
    wall = time_throughput(fn, (x,), iters=iters)
    return BenchResult(
        name=f"membench_{pattern}",
        metric=f"{pattern} bandwidth", value=bytes_moved / wall / 1e9,
        unit="GB/s", wall_s=wall, bytes_moved=bytes_moved,
    ).finish()


def bench_h2d(mb: float = 64.0, iters: int = 8) -> BenchResult:
    """Host->device feed bandwidth (the ingest boundary; dc_sand's
    GPUDirect/vkgdr analog).  Measures jax.device_put of host int8
    chunks over the PCIe path the streaming runner feeds through."""
    import numpy as np
    import time as _time
    n = int(mb * 1e6)
    host = [np.random.default_rng(i).integers(
        -100, 100, n, dtype=np.int8) for i in range(iters)]
    dev = jax.devices()[0]
    # warm one transfer
    jax.block_until_ready(jax.device_put(host[0], dev))
    t0 = _time.perf_counter()
    outs = [jax.device_put(h, dev) for h in host]
    jax.block_until_ready(outs)
    wall = (_time.perf_counter() - t0) / iters
    return BenchResult(
        name="membench_h2d", metric="host->device bandwidth",
        value=n / wall / 1e9, unit="GB/s", wall_s=wall, bytes_moved=n,
    ).finish()
