"""Per-channel gain + 8-bit requantisation (C6), and dequantisation.

Golden semantics: :func:`dc_sand_tpu.golden.chain.requantize` — complex
gain multiply, round-half-even, saturate to [-127, 127].

Representation of "complex int8": a trailing axis of length 2 holding
(re, im) int8 — complex integer dtypes don't exist in XLA, and this layout
feeds the X-engine's s8 x s8 -> s32 dots directly (SURVEY.md C8).  Elementwise;
XLA fuses it into the phase-rotation stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["requantize", "dequantize"]


def requantize(spectra: jnp.ndarray, gains: jnp.ndarray) -> jnp.ndarray:
    """complex64 ``(..., k)`` * complex gains -> int8 ``(..., k, 2)``.

    jnp.rint rounds half-to-even, matching the golden model exactly.
    """
    scaled = spectra * gains.astype(jnp.complex64)
    re = jnp.clip(jnp.rint(scaled.real), -127, 127).astype(jnp.int8)
    im = jnp.clip(jnp.rint(scaled.imag), -127, 127).astype(jnp.int8)
    return jnp.stack([re, im], axis=-1)


def dequantize(q: jnp.ndarray) -> jnp.ndarray:
    """int8 ``(..., 2)`` -> complex64 ``(...)``."""
    f = q.astype(jnp.float32)
    return jax.lax.complex(f[..., 0], f[..., 1])
