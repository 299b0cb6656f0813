"""B-engine: coherent multi-beam weighted sum (C10) + incoherent sum (C11).

Golden semantics: :func:`dc_sand_tpu.golden.chain.beamform` /
:func:`~dc_sand_tpu.golden.chain.incoherent_sum` (BASELINE.json:11).

Per channel the coherent beam is a (beam, ant) x (ant, pol*time) complex
matrix product, written as four real float32 einsums at ``HIGHEST``
precision: on a GPU a float32 dot at default precision may run in TF32
(about three decimal digits), which the >50 dB bound does not allow.

When antennas are sharded over the mesh the caller psums the partial
beams over the ``fx`` axis (SURVEY.md §2.3 parallelism table:
beam-parallel is the EP analog).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["beamform", "incoherent_sum"]

_P = jax.lax.Precision.HIGHEST


def _split_ri(x: jax.Array):
    """Accept complex arrays or wire-format ``(..., 2)`` re/im arrays."""
    if jnp.iscomplexobj(x):
        return (jnp.real(x).astype(jnp.float32),
                jnp.imag(x).astype(jnp.float32))
    return x[..., 0].astype(jnp.float32), x[..., 1].astype(jnp.float32)


def beamform(x: jax.Array, weights: jax.Array) -> jax.Array:
    """``y[e,p,b,k] = sum_a w[e,a,k] * x[a,p,b,k]``.

    ``x: (ant, pol, b, k, 2)`` int8/float32 wire format (or complex);
    ``weights: (beam, ant, k, 2)`` float32 wire format (or complex).
    Returns float32 ``(beam, pol, b, k, 2)``.
    """
    xr, xi = _split_ri(x)
    wr, wi = _split_ri(weights)

    def mm(w_, x_):
        return jnp.einsum("eak,apbk->epbk", w_, x_, precision=_P)

    yr = mm(wr, xr) - mm(wi, xi)
    yi = mm(wr, xi) + mm(wi, xr)
    return jnp.stack([yr, yi], axis=-1)


def incoherent_sum(x: jax.Array) -> jax.Array:
    """``sum_ant |x|^2`` per (pol, b, k), float32 (C11)."""
    xr, xi = _split_ri(x)
    return jnp.sum(xr * xr + xi * xi, axis=0)
