"""Stokes parameters from dual-pol beams (B-engine post-processing).

Tied-array beams are shipped either as raw complex voltages or as Stokes
power products; the GPU-correlator world computes these right after the
beamformer (dc_sand's beamformer experiments feed exactly such
detection stages).  For dual-pol beam voltages (x, y):

    I = |x|^2 + |y|^2        Q = |x|^2 - |y|^2
    U = 2 Re(x y*)           V = 2 Im(x y*)

Elementwise work, fused by XLA into the beamformer output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["stokes"]


def stokes(beams: jax.Array) -> jax.Array:
    """``beams: (beam, pol=2, b, k, 2)`` float32 wire format ->
    ``(beam, 4, b, k)`` float32 Stokes (I, Q, U, V)."""
    if beams.shape[1] != 2:
        raise ValueError("Stokes products need dual-pol beams "
                         f"(got {beams.shape[1]} pols)")
    xr, xi = beams[:, 0, ..., 0], beams[:, 0, ..., 1]
    yr, yi = beams[:, 1, ..., 0], beams[:, 1, ..., 1]
    px = xr * xr + xi * xi
    py = yr * yr + yi * yi
    re_xy = xr * yr + xi * yi      # Re(x conj(y))
    im_xy = xi * yr - xr * yi      # Im(x conj(y))
    return jnp.stack([px + py, px - py, 2 * re_xy, 2 * im_xy], axis=1)
