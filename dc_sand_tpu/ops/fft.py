"""Real->complex channelizer FFT (C4 in SURVEY.md §2.3).

This stays an ``rfft`` call (SURVEY.md C4: "jnp.fft.rfft first"), which
XLA hands to the GPU's FFT library; a hand-written kernel is only warranted
if a profile shows it far from its roofline (ROADMAP A3).
Golden semantics: :func:`dc_sand_tpu.golden.chain.channelize`.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["channelize"]


def channelize(fir_out: jnp.ndarray, n_chans: int) -> jnp.ndarray:
    """rfft over the last axis (length 2*n_chans), keep bins [0, n_chans).

    float32 in -> complex64 out (fp32 FFT is required for the 50 dB bound;
    bf16 would not reach it — SURVEY.md §7 hard parts).
    """
    spec = jnp.fft.rfft(fir_out.astype(jnp.float32), axis=-1)
    return spec[..., :n_chans]
