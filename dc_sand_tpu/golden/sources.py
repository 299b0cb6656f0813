"""Synthetic signal sources (C1 in SURVEY.md §2.3) — deterministic, float64.

Config 1 (BASELINE.json:7) requires a synthetic CW-tone stream; noise inputs
exercise the flat-PFB-response property tests.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cw_tone", "gaussian_noise", "gaussian_noise_int8", "quantize_adc"]


def cw_tone(n_samples: int, freq_hz: float, sample_rate_hz: float,
            amplitude: float = 100.0, phase: float = 0.0) -> np.ndarray:
    """Real-valued continuous-wave tone, float64, length ``n_samples``."""
    t = np.arange(n_samples, dtype=np.float64) / sample_rate_hz
    return amplitude * np.cos(2.0 * np.pi * freq_hz * t + phase)


def gaussian_noise(n_samples, sigma: float = 10.0, seed: int = 0) -> np.ndarray:
    """White Gaussian noise, float64.  ``n_samples`` may be a shape tuple."""
    rng = np.random.default_rng(seed)
    shape = n_samples if isinstance(n_samples, tuple) else (n_samples,)
    return rng.normal(0.0, sigma, size=shape)


def quantize_adc(x: np.ndarray) -> np.ndarray:
    """Digitise to int8: round-half-even, saturate to [-127, 127].

    The contract's chain runs int8 stages (BASELINE.json:5); MeerKAT's ADC is
    10-bit but the int8 path is what the contract specifies.  -128 is excluded
    to keep the code symmetric (standard correlator convention).
    """
    return np.clip(np.rint(x), -127, 127).astype(np.int8)


def gaussian_noise_int8(shape: tuple, sigma: float = 10.0,
                        seed: int = 0) -> np.ndarray:
    """``quantize_adc(gaussian_noise(shape, sigma, seed))`` without the
    float64 footprint — BIT-IDENTICAL output.

    ``gaussian_noise`` materialises the whole float64 array (64 ants x
    2 pol x 67.1 Msamp at the fx64 production cadence = 68.7 GB) and
    ``quantize_adc`` adds two more full-size temporaries (rint, clip) —
    ~200 GB transient, which is how the round-5 production-cadence
    verify got OOM-killed on a 125 GB host.  ``np.random.Generator``
    draws normals sequentially with no cross-call batching, so slicing
    the SAME seeded generator row-by-row in C-order drains the stream
    identically; each float64 slab is one row (~0.5 GB at production
    length) and only the int8 result is held.
    """
    rng = np.random.default_rng(seed)
    lead = shape[:-1]
    out = np.empty(shape, dtype=np.int8)
    if not lead:
        return quantize_adc(rng.normal(0.0, sigma, size=shape))
    flat = out.reshape(-1, shape[-1])
    for i in range(flat.shape[0]):
        flat[i] = quantize_adc(rng.normal(0.0, sigma, size=shape[-1]))
    return out
