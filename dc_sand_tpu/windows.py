"""Polyphase filterbank prototype-window generation (pure NumPy).

Shared by the float64 golden models (:mod:`dc_sand_tpu.golden`) and the JAX
ops (:mod:`dc_sand_tpu.ops`) so both sides filter with bit-identical
coefficients.

Contract: BASELINE.json:5 — "16-tap polyphase filterbank (Hann-windowed FIR
+ FFT) channelizer".  The prototype filter is the classic critically-sampled
PFB lowpass: a sinc at the channel spacing, windowed by a Hann window
(``kind="hann-sinc"``, the MeerKAT-style default), or a plain Hann window
(``kind="hann"``) for direct weighted-overlap-add spectral analysis.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pfb_window"]


def pfb_window(taps: int, fft_size: int, kind: str = "hann-sinc") -> np.ndarray:
    """Return the length ``taps * fft_size`` PFB prototype window (float64).

    The window is normalised so its coefficients sum to ``fft_size`` — a DC
    input of amplitude *a* then produces an FFT bin-0 amplitude of
    ``a * fft_size``, matching an unwindowed FFT's scaling.

    Parameters
    ----------
    taps:
        Number of polyphase taps (the contract's headline config uses 16).
    fft_size:
        FFT length ``M = 2 * n_chans`` for a real->complex channelizer.
    kind:
        ``"hann-sinc"`` — Hann-windowed sinc lowpass (flat passband per
        channel; standard radio-astronomy PFB prototype).
        ``"hann"`` — plain Hann window (config 1's "16-tap Hann FIR",
        BASELINE.json:7, reads literally as this; both are supported).
        ``"rect"`` — boxcar (plain polyphase average; debugging).
    """
    length = taps * fft_size
    n = np.arange(length, dtype=np.float64)
    if kind == "hann-sinc":
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))
        # sinc argument in units of the channel spacing; centred.
        x = (n - (length - 1) / 2.0) / fft_size
        w = hann * np.sinc(x)
    elif kind == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))
    elif kind == "rect":
        w = np.ones(length, dtype=np.float64)
    else:
        raise ValueError(f"unknown PFB window kind: {kind!r}")
    # Normalise: sum of coefficients == fft_size (see docstring).
    w *= fft_size / np.sum(w)
    return w
