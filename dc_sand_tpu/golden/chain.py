"""Float64 golden models of every pipeline stage (C2-C11, C17).

Stage semantics defined here are THE definition for the whole framework;
the JAX ops in :mod:`dc_sand_tpu.ops` implement exactly these formulas and
are verified against them at >50 dB SNR (BASELINE.json:5).

Array conventions
-----------------
* Raw streams: ``x[..., t]`` real (float64 or int8), time-major last axis.
* Spectra: ``s[..., b, k]`` complex128 — ``b`` spectrum (time block) index,
  ``k`` channel index, ``k in [0, n_chans)``.
* Multi-antenna arrays carry leading axes ``(ant, pol)``.

The critically-sampled real->complex PFB: FFT length ``M = 2 * n_chans``;
each spectrum consumes ``M`` new samples; the FIR window spans
``taps * M`` samples (overlap-save history of ``(taps-1) * M``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "apply_coarse_delay", "pfb_fir", "channelize", "fine_delay_fringe",
    "requantize", "corner_turn", "xcorr", "beamform", "incoherent_sum",
    "f_engine", "baseline_pairs", "stokes",
]


# ----------------------------------------------------------------------
# C2 — coarse delay
# ----------------------------------------------------------------------

def apply_coarse_delay(x: np.ndarray, delays: np.ndarray,
                       max_delay: int) -> np.ndarray:
    """Integer-sample delay per stream (C2).

    ``x[..., t]`` with at least ``max_delay`` lead-in samples reserved;
    ``delays[...]`` integer samples in ``[0, max_delay]`` broadcastable over
    the leading axes of ``x``.  Output ``y[..., t] = x[..., t + max_delay -
    delay]``, length ``x.shape[-1] - max_delay``: a stream delayed by *d*
    starts being read *d* samples earlier into the shared timeline, which is
    how a streaming F-engine realises coarse delay (read-pointer offset into
    the ring buffer).
    """
    x = np.asarray(x)
    delays = np.broadcast_to(np.asarray(delays, dtype=np.int64),
                             x.shape[:-1])
    if np.any(delays < 0) or np.any(delays > max_delay):
        raise ValueError("delays must lie in [0, max_delay]")
    n_out = x.shape[-1] - max_delay
    out = np.empty(x.shape[:-1] + (n_out,), dtype=x.dtype)
    for idx in np.ndindex(*x.shape[:-1]):
        start = max_delay - int(delays[idx])
        out[idx] = x[idx][start:start + n_out]
    return out


# ----------------------------------------------------------------------
# C3 + C4 — PFB-FIR and real FFT
# ----------------------------------------------------------------------

def pfb_fir(x: np.ndarray, window: np.ndarray, taps: int,
            fft_size: int) -> np.ndarray:
    """Weighted overlap-add FIR front half of the PFB (C3).

    ``y[..., b, n] = sum_t  w[t*M + n] * x[..., (b+t)*M + n]``
    for ``n in [0, M)``, ``t in [0, taps)``, ``M = fft_size``.

    Input length must be a multiple of ``M``; the number of output blocks is
    ``n_samples // M - (taps - 1)`` (the first ``taps-1`` blocks are history).
    Output float64 ``(..., B, M)``.
    """
    x = np.asarray(x, dtype=np.float64)
    m = fft_size
    if x.shape[-1] % m:
        raise ValueError(f"input length {x.shape[-1]} not a multiple of M={m}")
    n_blocks = x.shape[-1] // m
    b_out = n_blocks - (taps - 1)
    if b_out <= 0:
        raise ValueError("input shorter than the FIR window")
    frames = x.reshape(x.shape[:-1] + (n_blocks, m))
    w = np.asarray(window, dtype=np.float64).reshape(taps, m)
    out = np.zeros(x.shape[:-1] + (b_out, m), dtype=np.float64)
    for t in range(taps):
        out += w[t] * frames[..., t:t + b_out, :]
    return out


def channelize(fir_out: np.ndarray, n_chans: int) -> np.ndarray:
    """Real->complex FFT half of the PFB (C4).

    ``rfft`` over the last axis (length ``2*n_chans``); keep channels
    ``0..n_chans-1`` (the Nyquist bin is dropped, matching an ``n_chans``
    channel correlator output).
    """
    spec = np.fft.rfft(fir_out, axis=-1)
    return spec[..., :n_chans]


# ----------------------------------------------------------------------
# C5 — fine delay + fringe rotation
# ----------------------------------------------------------------------

def fine_delay_fringe(spectra: np.ndarray, frac_delay: np.ndarray,
                      phase: np.ndarray) -> np.ndarray:
    """Per-channel phase ramp: fine (sub-sample) delay + fringe phase (C5).

    ``out[..., b, k] = s[..., b, k] * exp(-j * (2*pi * k * d[..., b] / M
    + p[..., b]))`` with ``M = 2 * n_chans``; ``frac_delay`` in samples
    (sub-sample residual after coarse delay), ``phase`` in radians, both
    broadcastable over ``spectra.shape[:-1]`` (i.e. per stream, per
    spectrum).
    """
    spectra = np.asarray(spectra, dtype=np.complex128)
    n_chans = spectra.shape[-1]
    m = 2 * n_chans
    k = np.arange(n_chans, dtype=np.float64)
    d = np.asarray(frac_delay, dtype=np.float64)[..., None]
    p = np.asarray(phase, dtype=np.float64)[..., None]
    theta = -(2.0 * np.pi / m) * k * d - p
    return spectra * np.exp(1j * theta)


# ----------------------------------------------------------------------
# C6 — requantisation
# ----------------------------------------------------------------------

def requantize(spectra: np.ndarray, gains: np.ndarray) -> np.ndarray:
    """Per-channel complex gain then 8-bit requantisation (C6).

    ``y = clip(rint(Re/Im(s * g)), -127, 127)``, returned as complex128
    holding exact integer values (the JAX side stores int8 re/im pairs with
    the same values).  ``gains[..., k]`` complex, broadcastable against
    ``spectra``'s ``(..., b, k)``.
    """
    scaled = np.asarray(spectra, dtype=np.complex128) * np.asarray(
        gains, dtype=np.complex128)
    re = np.clip(np.rint(scaled.real), -127, 127)
    im = np.clip(np.rint(scaled.imag), -127, 127)
    return re + 1j * im


# ----------------------------------------------------------------------
# C7 — corner-turn
# ----------------------------------------------------------------------

def corner_turn(spectra: np.ndarray) -> np.ndarray:
    """(ant, pol, b, k) -> (k, ant, pol, b): antenna-major to channel-major.

    In the distributed pipeline this is the device all-to-all
    (BASELINE.json:5,10); the golden model is the pure data-movement
    semantics: a transpose.
    """
    return np.moveaxis(spectra, -1, 0)


# ----------------------------------------------------------------------
# C8/C9 — X-engine cross-correlation + accumulation
# ----------------------------------------------------------------------

def baseline_pairs(n_ants: int) -> np.ndarray:
    """Canonical baseline ordering: (i, j) for i<=j, i-major.

    2080 pairs at 64 antennas including autos (BASELINE.json:5).  Shared by
    golden and JAX X-engines so visibility layouts match index-for-index.
    """
    return np.array([(i, j) for i in range(n_ants)
                     for j in range(i, n_ants)], dtype=np.int32)


def xcorr(spectra: np.ndarray) -> np.ndarray:
    """X-engine CMAC (C8) + integration over the spectra axis (C9).

    Input ``x[ant, pol, b, k]`` complex (requantised F-engine output).
    Output visibilities ``V[bl, pi, pj, k] = sum_b x[i, pi, b, k] *
    conj(x[j, pj, b, k])`` over the canonical ``baseline_pairs`` ordering —
    4 pol products per baseline (BASELINE.json:9,10).
    """
    x = np.asarray(spectra, dtype=np.complex128)
    n_ants = x.shape[0]
    full = np.einsum("apbk,cqbk->acpqk", x, np.conj(x))
    pairs = baseline_pairs(n_ants)
    return full[pairs[:, 0], pairs[:, 1]]  # (n_bl, pi, pj, k)


# ----------------------------------------------------------------------
# C10/C11 — beamformer
# ----------------------------------------------------------------------

def beamform(spectra: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Coherent multi-beam weighted sum over antennas (C10).

    ``y[beam, pol, b, k] = sum_ant w[beam, ant, k] * x[ant, pol, b, k]``
    (weights shared across polarisation — per-pol beams use the same
    geometric weights; BASELINE.json:11).
    """
    x = np.asarray(spectra, dtype=np.complex128)
    w = np.asarray(weights, dtype=np.complex128)
    return np.einsum("eak,apbk->epbk", w, x)


def incoherent_sum(spectra: np.ndarray) -> np.ndarray:
    """Incoherent beam: sum_ant |x|^2, per (pol, b, k) (C11)."""
    x = np.asarray(spectra, dtype=np.complex128)
    return np.sum(np.abs(x) ** 2, axis=0)


# ----------------------------------------------------------------------
# Composed F-engine (C2..C6) — the per-antenna golden chain
# ----------------------------------------------------------------------

def f_engine(x: np.ndarray, window: np.ndarray, taps: int, n_chans: int,
             *, coarse_delays=None, max_delay: int = 0,
             frac_delay=None, phase=None, gains=None) -> np.ndarray:
    """Full golden F-engine: coarse delay -> PFB -> fine delay/fringe ->
    requantise.  Optional stages are skipped when their parameters are None
    (config 1 runs the bare PFB, BASELINE.json:7).

    ``x[..., t]`` real input; returns ``(..., b, k)`` complex128 spectra.
    ``frac_delay``/``phase`` are per-spectrum arrays broadcastable over the
    output's leading+block axes.
    """
    m = 2 * n_chans
    if coarse_delays is not None:
        x = apply_coarse_delay(x, coarse_delays, max_delay)
    fir = pfb_fir(x, window, taps, m)
    spec = channelize(fir, n_chans)
    if frac_delay is not None or phase is not None:
        fd = 0.0 if frac_delay is None else frac_delay
        ph = 0.0 if phase is None else phase
        spec = fine_delay_fringe(spec, np.asarray(fd), np.asarray(ph))
    if gains is not None:
        spec = requantize(spec, gains)
    return spec


def stokes(beams: np.ndarray) -> np.ndarray:
    """Stokes (I, Q, U, V) from dual-pol complex beams ``(beam, 2, b, k)``
    -> ``(beam, 4, b, k)`` float64 (golden model for ops/stokes.py)."""
    x = np.asarray(beams[:, 0], dtype=np.complex128)
    y = np.asarray(beams[:, 1], dtype=np.complex128)
    px, py = np.abs(x) ** 2, np.abs(y) ** 2
    xy = x * np.conj(y)
    return np.stack([px + py, px - py, 2 * xy.real, 2 * xy.imag], axis=1)
