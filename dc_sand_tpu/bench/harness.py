"""Benchmark harness (C18): timing, bytes-moved accounting, JSON records.

Measurement protocol (BASELINE.md): compile and warm-up excluded,
``block_until_ready`` walls, median of the timed calls, samples/s per
device = input real samples consumed / wall / devices, roofline share from
analytically-counted bytes over the device's published peak, results
recorded as JSON under ``bench/results/`` keyed by config hash + commit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time
from typing import Callable, Optional

import jax

__all__ = ["time_fn", "time_throughput", "BenchResult", "PEAKS",
           "device_kind", "peaks_for"]

# Published peaks per device kind (``jax.devices()[0].device_kind``).
# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the
# card's full 700 W power limit: bytes/s of HBM3, FLOP/s (or OP/s for
# int8) of the tensor cores, and float32 outside the tensor cores.
# "cpu" is an explicit entry with no roofline; any other kind is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12,
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
    },
    "cpu": None,
}


def device_kind() -> str:
    """``device_kind`` of the default device (``"cpu"`` on the CPU)."""
    return jax.devices()[0].device_kind


def peaks_for(kind: str) -> Optional[dict]:
    """The peaks of ``kind``; ``None`` for the CPU (no roofline)."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> float:
    """Median wall seconds per call of ``fn(*args)``, each call ending in
    ``block_until_ready`` (donated args must not be passed)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_throughput(fn: Callable, args: tuple, iters: int = 16) -> float:
    """Median wall seconds per call of ``jax.jit(fn)(*args)``.

    Compiles and warms first, so compilation never enters the timed
    calls; every timed call ends in ``block_until_ready``."""
    compiled = jax.jit(fn).lower(*args).compile()
    return time_fn(compiled, *args, warmup=2, iters=iters)


@dataclasses.dataclass
class BenchResult:
    name: str
    metric: str
    value: float
    unit: str
    wall_s: float
    config_hash: str = ""
    bytes_moved: Optional[float] = None
    hbm_roofline_frac: Optional[float] = None
    extra: dict = dataclasses.field(default_factory=dict)

    def finish(self, kind: Optional[str] = None) -> "BenchResult":
        """Stamp the device kind and, where the device has published
        peaks, the HBM roofline share of ``bytes_moved``."""
        kind = kind or device_kind()
        peaks = peaks_for(kind)
        if self.bytes_moved and self.wall_s:
            bw = self.bytes_moved / self.wall_s
            if peaks is not None:
                self.hbm_roofline_frac = bw / peaks["hbm_bytes_s"]
            self.extra["achieved_gb_s"] = bw / 1e9
        self.extra["device_kind"] = kind
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def save(self, results_dir: str = "bench/results") -> str:
        os.makedirs(results_dir, exist_ok=True)
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                text=True, timeout=5).stdout.strip() or "nogit"
        except (OSError, subprocess.SubprocessError):
            commit = "nogit"
        path = os.path.join(
            results_dir, f"{self.name}_{commit}_{int(time.time())}.json")
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path
