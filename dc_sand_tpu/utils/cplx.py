"""Complex <-> stacked-real (re, im) conversion helpers.

The framework's wire format for complex data at every jit/device boundary
is a trailing axis of length 2 holding (re, im):

* int8 ``(..., 2)`` for quantised spectra (feeds the int8 X-engine),
* float32 ``(..., 2)`` for unquantised spectra, gains and beam weights.

Rationale: int8 complex never exists as a dtype anywhere, the int8 pairs
feed the X-engine's s8 x s8 -> s32 dots directly, and keeping one wire
format everywhere makes the corner-turn/all-to-all layouts explicit.
Complex64 is used only *inside* jitted programs (FFT, phase rotation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["c2ri", "ri2c", "np_ri2c", "np_c2ri"]


def c2ri(x: jax.Array, dtype=jnp.float32) -> jax.Array:
    """complex (...,) -> real (..., 2)."""
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1).astype(dtype)


def ri2c(x: jax.Array) -> jax.Array:
    """real (..., 2) -> complex64 (...)."""
    f = x.astype(jnp.float32)
    return jax.lax.complex(f[..., 0], f[..., 1])


def np_ri2c(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x[..., 0] + 1j * x[..., 1]


def np_c2ri(x, dtype=np.float32) -> np.ndarray:
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(dtype)
