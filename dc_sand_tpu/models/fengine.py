"""The F-engine: coarse delay -> PFB -> fine delay/fringe -> requantise.

JAX mirror of :func:`dc_sand_tpu.golden.chain.f_engine` (C2..C6), jittable
and shard_map-able over the antenna axis (each antenna's F-engine is
independent — the DP analog in SURVEY.md §2.3's parallelism table).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from dc_sand_tpu import ops
from dc_sand_tpu.utils.cplx import c2ri, ri2c

__all__ = ["f_engine", "coarse_delay"]


def coarse_delay(x: jax.Array, delays: jax.Array, max_delay: int) -> jax.Array:
    """Integer-sample delay via read-pointer offset (C2).

    ``x: (..., T)`` with ``max_delay`` lead-in samples; ``delays`` int32
    broadcastable over the leading axes.  Output length ``T - max_delay``;
    stream delayed by d reads starting at ``max_delay - d``.  Implemented
    as a vmapped ``dynamic_slice`` — delays may be traced values (they
    change per chunk under jit).

    Out-of-range delays CLAMP to ``[0, max_delay]`` (``dynamic_slice``
    start-index semantics — a traced value cannot raise), unlike the
    golden model's ``ValueError``; :class:`~dc_sand_tpu.runtime.delays.
    DelayModel` clips at evaluation so runner-fed delays never hit the
    clamp.  Direct callers must bound their own delays.
    """
    lead = x.shape[:-1]
    t_len = x.shape[-1]
    n_out = t_len - max_delay
    xs = x.reshape(-1, t_len)
    ds = jnp.broadcast_to(jnp.asarray(delays, jnp.int32), lead).reshape(-1)

    def one(row, d):
        return jax.lax.dynamic_slice(row, (max_delay - d,), (n_out,))

    out = jax.vmap(one)(xs, ds)
    return out.reshape(lead + (n_out,))


def f_engine(x: jax.Array, window: jax.Array, taps: int, n_chans: int, *,
             coarse_delays: Optional[jax.Array] = None, max_delay: int = 0,
             frac_delay: Optional[jax.Array] = None,
             phase: Optional[jax.Array] = None,
             gains: Optional[jax.Array] = None,
             layout: str = "wire") -> jax.Array:
    """Full F-engine on ``x: (..., t)`` int8/float real streams.

    Wire format (complex never crosses the jit boundary — see
    :mod:`dc_sand_tpu.utils.cplx`): returns float32 ``(..., b, k, 2)``
    spectra when ``gains`` is None (config 1, BASELINE.json:7), else int8
    quantised ``(..., b, k, 2)`` (configs 2+, BASELINE.json:8).  ``gains``
    is float32 ``(..., k, 2)`` complex-as-ri.  ``layout="wire_flat"``
    returns the same bytes viewed as ``(..., b, 2k)``.
    """
    if layout not in ("wire", "wire_flat"):
        raise ValueError(f"unknown layout {layout!r} "
                         "(expected 'wire' or 'wire_flat')")
    if coarse_delays is not None:
        x = coarse_delay(x, coarse_delays, max_delay)
    fir = ops.pfb_fir(x, window, taps, 2 * n_chans)
    spec = ops.channelize(fir, n_chans)
    if frac_delay is not None or phase is not None:
        fd = jnp.asarray(0.0 if frac_delay is None else frac_delay)
        ph = jnp.asarray(0.0 if phase is None else phase)
        spec = ops.fine_delay_fringe(spec, fd, ph)
    if gains is not None:
        g = jnp.asarray(gains)
        if not jnp.iscomplexobj(g):
            g = ri2c(g)
        res = ops.requantize(spec, g)
    else:
        res = c2ri(spec)
    if layout == "wire_flat":
        # same bytes as (..., B, K, 2) row-major
        return res.reshape(res.shape[:-2] + (2 * n_chans,))
    return res
