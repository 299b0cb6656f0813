"""PFB-FIR: the 16-tap weighted overlap-add front half of the channelizer.

C3 in SURVEY.md §2.3 — the contract's headline kernel (BASELINE.json:5,7).
Golden semantics: :func:`dc_sand_tpu.golden.chain.pfb_fir`:

    ``y[s, b, n] = sum_t w[t*M + n] * x[s, (b+t)*M + n]``

Frames + windowed sum: XLA fuses the ``taps`` strided multiply-adds into
one loop fusion that reads int8 and writes float32.  Accumulation is
float32 (the >50 dB bound forbids bf16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pfb_fir"]


def pfb_fir(x: jax.Array, window: jax.Array, taps: int,
            fft_size: int) -> jax.Array:
    """Apply the polyphase FIR.  ``x: (..., T)`` int8/float, ``T % M == 0``;
    returns float32 ``(..., B, M)`` with ``B = T//M - (taps-1)``."""
    m = fft_size
    t_len = x.shape[-1]
    if t_len % m:
        raise ValueError(f"input length {t_len} not a multiple of M={m}")
    n_frames = t_len // m
    b_out = n_frames - (taps - 1)
    if b_out <= 0:
        raise ValueError("input shorter than the FIR window")
    w = jnp.asarray(window, dtype=jnp.float32).reshape(taps, m)
    f32 = x.reshape(x.shape[:-1] + (n_frames, m)).astype(jnp.float32)
    out = jnp.zeros(f32.shape[:-2] + (b_out, m), dtype=jnp.float32)
    for t in range(taps):
        out = out + w[t] * f32[..., t:t + b_out, :]
    return out
