"""Per-kernel benchmarks: X-engine CMAC, beamformer, corner-turn local
reorder, PFB stages (C18).

Reports the HBM roofline share and, for the matrix ops, the achieved
int8/fp32 rate — the dc_sand idiom of "timing scripts compared against
rooflines" (SURVEY.md §4.1), measured not eyeballed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dc_sand_tpu import ops
from dc_sand_tpu.bench.harness import BenchResult, time_throughput
from dc_sand_tpu.golden.chain import baseline_pairs

__all__ = ["bench_xcorr", "bench_beamform", "bench_fft"]


def bench_fft(n_chans: int = 1024, n_streams: int = 16,
              n_spectra: int = 512, iters: int = 64) -> list:
    """rfft implementations head to head at the channelizer shape (C4):
    XLA's ``rfft`` vs the matmul-formulated Cooley-Tukey split
    (``ops.fft_mxu.rfft_mxu``, the ROADMAP A3 candidate) — run both,
    read which wins at a given shape."""
    from dc_sand_tpu.ops.fft import channelize
    from dc_sand_tpu.ops.fft_mxu import channelize_mxu
    m = 2 * n_chans
    x = jax.block_until_ready(jax.jit(
        lambda: jax.random.normal(
            jax.random.key(0),
            (n_streams, n_spectra, m), jnp.float32) * 30)())
    out = []
    for name, fn in (("fft_xla_rfft", channelize),
                     ("fft_mxu_matmul", channelize_mxu)):
        wall = time_throughput(lambda x_: fn(x_, n_chans), (x,),
                               iters=iters)
        samples = n_streams * n_spectra * m
        # 5 M log2 M real FLOPs per length-M rfft (standard count); the
        # matmul path trades that for 6x-dense-DFT matmul MACs
        flops = 5 * samples * np.log2(m)
        out.append(BenchResult(
            name=name, metric="FFT samples/s",
            value=samples / wall, unit="samp/s", wall_s=wall,
            bytes_moved=samples * 4 + samples // 2 * 8,
            extra={"n_chans": n_chans, "n_streams": n_streams,
                   "n_spectra": n_spectra,
                   "equiv_gflops": flops / wall / 1e9},
        ).finish())
    return out


def bench_xcorr(n_ants: int = 64, n_pols: int = 2, n_chans: int = 4096,
                n_spectra: int = 256, iters: int = 16,
                mode: str = "accumulate") -> BenchResult:
    """X-engine CMAC throughput: baselines/s and CMAC/s of the s8 x s8
    -> s32 dots (BASELINE.json:2 primary metric 2).

    ``mode="accumulate"`` measures the streaming path the FX step runs
    (``ops.xcorr_accumulate`` into the packed accumulator, accumulator
    traffic included); ``mode="extract"`` the per-chunk
    extract+gather form (``ops.xcorr``)."""
    ap = n_ants * n_pols
    q = jax.block_until_ready(jax.jit(
        lambda: (jax.random.normal(
            jax.random.key(0),
            (n_chans, n_ants, n_pols, n_spectra, 2)) * 30)
        .astype(jnp.int8))())
    if mode == "accumulate":
        acc = jax.block_until_ready(
            jnp.zeros(ops.acc_shape(n_ants, n_pols, n_chans), jnp.int32))
        # acc rides as a real argument: a closed-over array would be
        # baked into the program as a (gigabyte) constant
        wall = time_throughput(
            lambda q_, a_: ops.xcorr_accumulate(a_, q_), (q, acc),
            iters=iters)
        acc_bytes = 2 * acc.size * 4          # read + write per chunk
    elif mode == "extract":
        wall = time_throughput(ops.xcorr, (q,), iters=iters)
        acc_bytes = 0
    else:
        raise ValueError(f"unknown mode {mode!r}")
    n_bl = len(baseline_pairs(n_ants))
    # complex MACs: full ap x ap matrix per channel per spectrum (the
    # computation actually performed; the triangle is what's kept)
    cmacs = n_chans * ap * ap * n_spectra
    kept_cmacs = n_chans * n_bl * 4 * n_spectra
    in_bytes = q.size
    out_bytes = (acc_bytes if acc_bytes
                 else n_bl * n_pols * n_pols * n_chans * 2 * 4)
    return BenchResult(
        name=f"xcorr_cmac_{mode}",
        metric="correlator baselines/s",
        value=n_bl * n_chans * n_spectra / wall,
        unit="baseline-chan-spectra/s", wall_s=wall,
        bytes_moved=in_bytes + out_bytes,
        extra={"cmac_per_s": cmacs / wall,
               "kept_cmac_per_s": kept_cmacs / wall,
               "int8_tops": 8 * cmacs / wall / 1e12,
               "mode": mode,
               "n_ants": n_ants, "n_chans": n_chans,
               "n_spectra": n_spectra},
    ).finish()


def bench_beamform(n_beams: int = 16, n_ants: int = 64, n_pols: int = 2,
                   n_chans: int = 4096, n_spectra: int = 64,
                   iters: int = 16,
                   quant_scale: float = 0.0) -> BenchResult:
    """Coherent beamformer throughput (C10); ``quant_scale > 0`` adds
    the int8 beam product's quantisation."""
    q = jax.block_until_ready(jax.jit(
        lambda: (jax.random.normal(
            jax.random.key(0),
            (n_ants, n_pols, n_spectra, n_chans, 2)) * 30)
        .astype(jnp.int8))())
    if quant_scale:
        def fn(q_, w_):
            y = ops.beamform(q_, w_)
            return jnp.clip(jnp.rint(y * quant_scale), -127,
                            127).astype(jnp.int8)
    else:
        fn = ops.beamform
    w = jax.block_until_ready(jax.jit(
        lambda: jax.random.normal(jax.random.key(1),
                                  (n_beams, n_ants, n_chans, 2),
                                  jnp.float32))())
    wall = time_throughput(fn, (q, w), iters=iters)
    flops = 4 * 2 * n_beams * n_ants * n_pols * n_spectra * n_chans
    in_bytes = q.size + w.size * 4
    out_bytes = n_beams * n_pols * n_spectra * n_chans * 2 * (
        1 if quant_scale else 4)
    return BenchResult(
        name="beamform" + ("_int8" if quant_scale else "")
             + (f"_{n_beams}b" if n_beams != 16 else ""),
        metric="beamformed samples/s",
        value=n_beams * n_pols * n_spectra * n_chans / wall,
        unit="beam-samples/s", wall_s=wall,
        bytes_moved=in_bytes + out_bytes,
        extra={"fp32_gflops": flops / wall / 1e9, "n_beams": n_beams,
               "n_ants": n_ants, "n_chans": n_chans,
               "quant_scale": quant_scale},
    ).finish()
