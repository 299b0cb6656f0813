"""Stage and pipeline benchmarks on the local device (C18).

The headline metric is BASELINE.json:2's "channelized samples/s/chip":
real input samples consumed per second by the F-engine (PFB-FIR + FFT,
plus delay/fringe/requant when enabled).  ``vs_realtime`` divides it by
the device's share of the deployment's real-time rate: the full
64-antenna dual-pol array at 1712 Msps is 64 x 2 x 1712e6 = 219.1e9 real
samples/s, split over the devices the run uses.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from dc_sand_tpu.bench.harness import BenchResult, time_throughput
from dc_sand_tpu.models import f_engine
from dc_sand_tpu.windows import pfb_window

__all__ = ["bench_fengine", "bench_fx_step", "bench_beam_step",
           "bench_runner_modes", "ARRAY_RATE", "realtime_share"]

# The 64-antenna dual-pol L-band array (BASELINE.json:5): real samples/s
ARRAY_RATE = 64 * 2 * 1712e6


def realtime_share(n_devices: int = 1) -> float:
    """Real samples/s one device must sustain when ``n_devices`` share
    the array's input in real time."""
    return ARRAY_RATE / n_devices


def bench_fengine(n_streams: int = 16, n_spectra: int = 512,
                  n_chans: int = 1024, taps: int = 16,
                  full_chain: bool = True,
                  iters: int = 16) -> BenchResult:
    """F-engine throughput on one device.

    ``full_chain=True`` adds fine-delay/fringe + requant (config-2 shape,
    BASELINE.json:8); False is the bare PFB (config 1).
    """
    m = 2 * n_chans
    n_frames = n_spectra + taps - 1
    rng = np.random.default_rng(0)
    # make the input on device: the host-to-device copy is not the
    # F-engine's cost and stays out of the timed calls
    x = jax.block_until_ready(jax.jit(
        lambda: (jax.random.normal(jax.random.key(0),
                                   (n_streams, n_frames * m)) * 30)
        .astype(jnp.int8))())
    w = pfb_window(taps, m)
    if full_chain:
        gains = jnp.asarray(
            np.stack([np.full((n_chans,), 0.05, np.float32),
                      np.zeros((n_chans,), np.float32)], axis=-1))
        fd = jnp.asarray(rng.uniform(-0.5, 0.5,
                                     size=(n_streams, n_spectra)),
                         dtype=jnp.float32)
        ph = jnp.zeros((n_streams, n_spectra), jnp.float32)

        def step(xx, fd_, ph_, g_):
            return f_engine(xx, w, taps, n_chans, frac_delay=fd_, phase=ph_,
                            gains=g_)

        args = (x, fd, ph, gains)
    else:
        def step(xx):
            return f_engine(xx, w, taps, n_chans)

        args = (x,)

    wall = time_throughput(step, args, iters=iters)
    samples = n_streams * n_spectra * m  # new samples consumed per call
    rate = samples / wall
    # bytes the F-engine must move at least: int8 in + output (int8 x2
    # quantised, or fp32 x2 unquantised)
    out_bytes = n_streams * n_spectra * n_chans * (2 if full_chain else 8)
    bytes_moved = samples * 1 + out_bytes
    extra = {"n_streams": n_streams, "n_spectra": n_spectra,
             "n_chans": n_chans, "taps": taps,
             "vs_realtime": rate / realtime_share()}
    return BenchResult(
        name=f"fengine_{'full' if full_chain else 'pfb'}",
        metric="channelized samples/s/chip", value=rate, unit="samp/s",
        wall_s=wall, bytes_moved=bytes_moved, extra=extra,
    ).finish()


def _step_bench_setup(preset: str, taps: int, weights, **overrides):
    """Shared setup for the end-to-end step benches: config + jitted
    production step (coarse delay on the host/ingest path) + staged
    device inputs.  Returns (cfg, step, history, vis_acc, chunk, rest)
    with ``rest = (coarse, frac, phase, gains, weights, reset)``."""
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.models.pipeline import (make_step, zero_vis_acc,
                                             history_len)

    cfg = get_config(preset).replace(**overrides)
    window = pfb_window(taps, cfg.fft_size)
    step = make_step(cfg, window, max_delay=0, mesh=None,
                     donate=True, coarse_on_host=True)
    a, p, k, b = (cfg.n_ants, cfg.n_pols, cfg.n_chans,
                  cfg.spectra_per_chunk)
    history = jnp.zeros((a, p, history_len(cfg, 0)), jnp.int8)
    vis_acc = zero_vis_acc(cfg)
    # make the chunk on device (see bench_fengine)
    chunk = jax.block_until_ready(jax.jit(
        lambda: (jax.random.normal(jax.random.key(0),
                                   (a, p, cfg.chunk_samples)) * 30)
        .astype(jnp.int8))())
    rest = (jnp.zeros((a, p), jnp.int32),
            jnp.zeros((a, p, b), jnp.float32),
            jnp.zeros((a, p, b), jnp.float32),
            jnp.asarray(np.stack([np.full((k,), 0.05, np.float32),
                                  np.zeros((k,), np.float32)], -1)),
            weights, jnp.asarray(False))
    return cfg, step, history, vis_acc, chunk, rest


def _time_step_chain(step, history, vis_acc, chunk, rest,
                     iters: int) -> float:
    """Median wall seconds per streaming step, the carry chained through
    the donated ``(history, vis_acc)`` as the runner does.  Each timed
    call ends in ``block_until_ready`` on its outputs; the first (the
    compile) and a warm-up call are not timed."""
    walls = []
    for i in range(iters + 2):
        t0 = time.perf_counter()
        history, vis_acc, outs = step(history, vis_acc, chunk, *rest)
        jax.block_until_ready((history, vis_acc, outs))
        if i >= 2:
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def bench_fx_step(n_ants: int = 64, n_pols: int = 2, n_chans: int = 1024,
                  n_spectra: int = None, taps: int = 16,
                  iters: int = 64) -> BenchResult:
    """End-to-end single-device FX streaming step (the flagship path:
    full F-engine -> local corner-turn -> X-engine CMAC + accumulate),
    i.e. ``__graft_entry__.entry``'s program.

    ``n_spectra`` defaults to the fx64 preset's own chunk size — the
    cadence the production runner dispatches."""
    if n_spectra is None:
        from dc_sand_tpu.config import get_config
        n_spectra = get_config("fx64").spectra_per_chunk
    a, p, k, b = n_ants, n_pols, n_chans, n_spectra
    cfg, step, history, vis_acc, chunk, rest = _step_bench_setup(
        "fx64", taps, jnp.zeros((1, a, k, 2), jnp.float32),
        n_ants=a, n_pols=p, n_chans=k, spectra_per_chunk=b)

    wall = _time_step_chain(step, history, vis_acc, chunk, rest, iters)
    samples = a * p * cfg.chunk_samples
    return BenchResult(
        name="fx_step_64ant",
        metric="FX-step samples/s/chip", value=samples / wall,
        unit="samp/s", wall_s=wall,
        # int8 stream in + packed-triangle accumulator (k, ap, ap)
        # int32 in/out
        bytes_moved=samples + 2 * k * (a * p) ** 2 * 4,
        extra={"n_ants": a, "n_chans": k, "n_spectra": b,
               "vs_realtime": samples / wall / realtime_share()},
    ).finish()


def bench_runner_modes(n_ants: int = 16, n_pols: int = 2,
                       n_chans: int = 1024, spectra: int = 64,
                       n_chunks: int = 16):
    """Streaming ``run`` vs offline ``run_batched`` on the same runner
    config: quantifies the per-dispatch overhead the batched scan
    amortises (one dispatch per dump window instead of per chunk).
    Returns both records."""
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.runtime import FXRunner
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx64").replace(
        n_ants=n_ants, n_pols=n_pols, n_chans=n_chans,
        spectra_per_chunk=spectra, n_spectra_per_acc=4 * spectra)
    rng = np.random.default_rng(0)
    n_cache = 4 * (cfg.n_spectra_per_acc // spectra)
    chunks = [rng.integers(-100, 100,
                           (n_ants, n_pols, cfg.chunk_samples),
                           dtype=np.int8) for _ in range(n_cache)]
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    results = []
    for mode in ("batched", "streaming"):
        r = FXRunner(cfg, window)
        fn = r.run_batched if mode == "batched" else r.run
        fn(lambda i: chunks[i % n_cache], n_cache)      # warm + compile
        t0 = time.perf_counter()
        fn(lambda i: chunks[(i + 1) % n_cache], n_chunks)
        wall = time.perf_counter() - t0
        samples = n_ants * n_pols * cfg.chunk_samples * n_chunks
        results.append(BenchResult(
            name=f"runner_{mode}",
            metric="runner samples/s", value=samples / wall,
            unit="samp/s", wall_s=wall / n_chunks, bytes_moved=samples,
            extra={"n_ants": n_ants, "n_chans": n_chans,
                   "spectra": spectra, "n_chunks": n_chunks,
                   "chunks_per_dispatch":
                       (cfg.n_spectra_per_acc // spectra
                        if mode == "batched" else 1)},
        ).finish())
    return results


def bench_beam_step(n_ants: int = 64, n_pols: int = 2,
                    n_chans: int = 4096, n_spectra: int = 256,
                    n_beams: int = 16, taps: int = 16,
                    iters: int = 64) -> BenchResult:
    """End-to-end single-device B-engine streaming step (config 5's
    device path: full F-engine -> coherent beamformer + incoherent
    sum), timed as :func:`bench_fx_step`."""
    a, p, k, b = n_ants, n_pols, n_chans, n_spectra
    rng = np.random.default_rng(3)
    weights = jnp.asarray(
        rng.normal(size=(n_beams, a, k, 2)).astype(np.float32) * 0.1)
    cfg, step, history, vis_acc, chunk, rest = _step_bench_setup(
        "beam64", taps, weights, n_ants=a, n_pols=p, n_chans=k,
        n_beams=n_beams, spectra_per_chunk=b)

    wall = _time_step_chain(step, history, vis_acc, chunk, rest, iters)
    samples = a * p * cfg.chunk_samples
    out_bytes = (n_beams + 1) * p * b * k * 8
    return BenchResult(
        name="beam_step_64ant",
        metric="B-engine-step samples/s/chip", value=samples / wall,
        unit="samp/s", wall_s=wall,
        bytes_moved=samples + out_bytes,
        extra={"n_ants": a, "n_chans": k, "n_spectra": b,
               "n_beams": n_beams,
               "vs_realtime": samples / wall / realtime_share()},
    ).finish()
