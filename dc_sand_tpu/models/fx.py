"""FX correlator pipelines (configs 3 & 4, BASELINE.json:9,10).

``fx_step_local`` is the single-device composition (config 3);
``make_sharded_fx_step`` wraps it in ``shard_map`` over the ``fx`` mesh
axis: antenna-sharded F-engines -> all-to-all corner-turn ->
channel-sharded X-engines (config 4).  ``make_time_sharded_fengine``
shards the *sample stream* instead, with the overlap-save halo exchange
(the SP/context-parallel mode).

Call stack mirror of SURVEY.md §3.4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dc_sand_tpu import ops
from dc_sand_tpu.models.fengine import f_engine
from dc_sand_tpu.parallel import (FX_AXIS, TIME_AXIS,
                                  corner_turn_all_to_all,
                                  halo_exchange_left)

__all__ = ["fx_step_local", "make_sharded_fx_step",
           "make_time_sharded_fengine"]


def fx_step_local(x, window, taps, n_chans, *, frac_delay=None, phase=None,
                  gains=None, coarse_delays=None, max_delay=0):
    """Single-device FX: F-engine -> (local) corner-turn -> X-engine.

    ``x: (ant, pol, t)`` int8 -> visibilities ``(n_bl, pol, pol, k, 2)``
    int32, integrated over the chunk's spectra (C8+C9).
    """
    q = f_engine(x, window, taps, n_chans, coarse_delays=coarse_delays,
                 max_delay=max_delay, frac_delay=frac_delay, phase=phase,
                 gains=gains)
    # local corner-turn: (ant, pol, b, k, 2) -> (k, ant, pol, b, 2)
    qk = jnp.moveaxis(q, 3, 0)
    return ops.xcorr(qk)


def make_sharded_fx_step(mesh, window, taps: int, n_chans: int,
                         n_ants: int, *, quantized: bool = True,
                         max_delay: int = 0):
    """Build the jitted SPMD FX step over the ``fx`` mesh axis.

    Layout contract (BASELINE.json:5,10):

    * in: ``x (ant, pol, t)`` sharded on ant; ``frac_delay/phase
      (ant, pol, b)`` sharded on ant; ``gains (k, 2)`` replicated;
      optional ``coarse_delays (ant, pol)`` sharded on ant.
    * F-engine runs on local antennas only (no comm);
    * corner-turn = all_to_all re-sharding ant-major -> channel-major;
    * X-engine CMAC on local channel block, all antennas;
    * out: visibilities ``(n_bl, pol, pol, k, 2)`` sharded on the channel
      axis (3).
    """
    n_fx = mesh.shape[FX_AXIS]
    if n_ants % n_fx or n_chans % n_fx:
        raise ValueError(f"ants {n_ants} and chans {n_chans} must divide "
                         f"over {n_fx} fx shards")

    def step(x, frac_delay, phase, gains, coarse_delays):
        q = f_engine(x, window, taps, n_chans,
                     coarse_delays=coarse_delays, max_delay=max_delay,
                     frac_delay=frac_delay, phase=phase,
                     gains=gains if quantized else None)
        q = corner_turn_all_to_all(q, FX_AXIS)  # (ant, pol, b, k_l, 2)
        qk = jnp.moveaxis(q, 3, 0)              # (k_l, ant, pol, b, 2)
        return ops.xcorr(qk)                    # (n_bl, p, p, k_l, 2)

    a = P(FX_AXIS)
    shard = jax.shard_map(
        step, mesh=mesh,
        in_specs=(a, a, a, P(), a),
        out_specs=P(None, None, None, FX_AXIS),
    )
    return jax.jit(shard)


def make_time_sharded_fengine(mesh, window, taps: int, n_chans: int):
    """Build a jitted F-engine with the sample stream sharded over the
    ``time`` mesh axis (SP mode): each chip channelizes a contiguous
    stream segment after receiving the overlap-save halo from its left
    neighbour (C14).

    in: ``x (ant, pol, t)`` sharded on t (axis 2); out: float32 spectra
    ``(ant, pol, b, k, 2)`` sharded on b (axis 2).  The caller feeds a
    stream whose length is ``n_time_shards * b_local * 2*n_chans``; shard
    0's first ``taps-1`` spectra use zero history (stream cold start).
    """
    m = 2 * n_chans
    halo = (taps - 1) * m

    def step(x_local):
        xh = halo_exchange_left(x_local, halo, TIME_AXIS)
        fir = ops.pfb_fir(xh, window, taps, m)
        spec = ops.channelize(fir, n_chans)
        from dc_sand_tpu.utils.cplx import c2ri
        return c2ri(spec)

    shard = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(None, None, TIME_AXIS),),
        out_specs=P(None, None, TIME_AXIS),
    )
    return jax.jit(shard)
