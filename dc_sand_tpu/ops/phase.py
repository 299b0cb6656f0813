"""Fine delay + fringe rotation (C5): per-channel phase ramp.

Golden semantics: :func:`dc_sand_tpu.golden.chain.fine_delay_fringe`.
Pure elementwise complex64 work — XLA fuses this into the surrounding
FFT/requant stages (SURVEY.md C5: "fused elementwise"); a dedicated
kernel would only add a materialisation boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["fine_delay_fringe"]


def fine_delay_fringe(spectra: jnp.ndarray, frac_delay: jnp.ndarray,
                      phase: jnp.ndarray) -> jnp.ndarray:
    """``out[..., b, k] = s * exp(-j*(2 pi k d/M + p))``, complex64.

    ``frac_delay`` (samples) and ``phase`` (radians) broadcast over
    ``spectra.shape[:-1]`` — i.e. per stream, per spectrum.
    """
    n_chans = spectra.shape[-1]
    m = 2 * n_chans
    k = jnp.arange(n_chans, dtype=jnp.float32)
    d = jnp.asarray(frac_delay, dtype=jnp.float32)[..., None]
    p = jnp.asarray(phase, dtype=jnp.float32)[..., None]
    theta = -(2.0 * jnp.pi / m) * k * d - p
    rot = jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
    return spectra.astype(jnp.complex64) * rot
