"""The jitted streaming step factory — one compiled SPMD program per
config, shared by the runner, the CLI and the multichip dry-run.

``make_step`` composes C2..C11 into a single donated-carry step:

    (history, vis_acc, chunk, coarse, frac, phase, gains, weights, reset)
        -> (history', vis_acc', outputs)

Modes (cfg-driven):
* ``fengine`` — quantised (or raw) spectra out (configs 1-2).
* ``fx``      — corner-turn + X-engine, visibility accumulator carried
                (configs 3-4).
* ``beam``    — coherent multi-beam + incoherent sum fused with the
                F-engine (config 5); when antennas are sharded the beam
                sums finish with a psum over the fx axis.

With a mesh, the same step runs under shard_map: history/chunk/delay
state sharded on the antenna axis, visibilities on the channel axis,
beams replicated after psum (BASELINE.json:5,10,11).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dc_sand_tpu import ops
from dc_sand_tpu.config import ChainConfig
from dc_sand_tpu.models.fengine import coarse_delay, f_engine
from dc_sand_tpu.parallel import FX_AXIS, corner_turn_all_to_all

__all__ = ["make_step", "history_len", "mode_for", "zero_vis_acc"]


def history_len(cfg: ChainConfig, max_delay: int) -> int:
    """Carried raw-stream tail: coarse-delay lead-in + FIR overlap.

    In SP mode (``cfg.time_shards > 1``) the carry is sharded over the
    time axis — one overlap-save block per shard (only shard 0's block
    is live; it holds the previous chunk's global stream tail), so the
    global carry is ``time_shards`` blocks long and coarse delay must
    ride the host/ingest path (``max_delay == 0``).
    """
    if cfg.time_shards > 1:
        if max_delay:
            raise ValueError("SP mode needs coarse delay on the "
                             "host/ingest path (max_delay must be 0)")
        return cfg.time_shards * cfg.history_len
    return max_delay + cfg.history_len


def zero_vis_acc(cfg: ChainConfig) -> jnp.ndarray:
    """Zeroed X-engine integration carry for ``make_step``.

    fx mode carries the (k, ap, ap) int32 packed-triangle accumulator
    (ops.xcorr.acc_shape: vr upper / vi lower) — baselines are
    extracted once per dump, not per chunk; other modes carry a rank-1
    dummy."""
    from dc_sand_tpu.ops.xcorr import acc_shape
    if mode_for(cfg) == "fx":
        shape = acc_shape(cfg.n_ants, cfg.n_pols, cfg.n_chans)
        if cfg.time_shards > 1:
            # SP fx: one partial accumulator per time shard (sharded
            # (time, fx) — each shard integrates its own stream
            # segment); dump extraction sums over axis 0, so the
            # all-reduce over time rides the dump cadence, not the
            # chunk cadence
            return jnp.zeros((cfg.time_shards,) + shape, jnp.int32)
        return jnp.zeros(shape, jnp.int32)
    return jnp.zeros((1,), jnp.int32)


def mode_for(cfg: ChainConfig) -> str:
    if cfg.n_beams > 0:
        return "beam"
    if cfg.run_xengine:
        return "fx"
    return "fengine"


def make_step(cfg: ChainConfig, window, *, max_delay: int = 0,
              mesh=None, donate: bool = True,
              coarse_on_host: bool = True):
    """Build the jitted streaming step for ``cfg`` (optionally SPMD).

    ``coarse_on_host=True`` (the default and production mode, used by
    the runner) skips the on-device coarse delay: integer-sample delay
    is a read-pointer offset and belongs at the ingest boundary, where
    it costs a placement offset instead of a device-side vmapped int8
    gather over the whole chunk.  Only the sub-sample residual
    (fine-delay phase ramp) runs on device.  Pass ``False`` (with
    ``max_delay > 0``) to fold the integer gather into the device step
    instead.
    """
    mode = mode_for(cfg)
    taps, n_chans = cfg.n_taps, cfg.n_chans
    quantized = cfg.apply_requant
    device_coarse = cfg.apply_delay and not coarse_on_host
    if max_delay and not device_coarse:
        # a lead-in only exists to feed the device coarse gather; with
        # coarse on the host/ingest path the step would silently drop
        # the lead-in and IGNORE the coarse argument — misaligned
        # visibilities with no error
        raise ValueError(
            "max_delay > 0 requires the device coarse path "
            "(coarse_on_host=False with cfg.apply_delay); host/ingest "
            "coarse modes take max_delay=0")
    if cfg.beam_stokes and (mode != "beam" or cfg.n_pols != 2):
        raise ValueError("beam_stokes needs dual-pol beams "
                         f"(mode={mode}, n_pols={cfg.n_pols})")
    beam_parallel = bool(cfg.beam_parallel) and mesh is not None
    if cfg.beam_parallel:
        if mesh is None:
            # without a mesh the step would run single-device
            # replicated while the caller believes EP sharding is
            # active (`cli run --beam-parallel` without --mesh)
            raise ValueError(
                "beam_parallel requires a mesh (pass mesh=/--mesh; "
                "without one the step would silently run replicated)")
        if mode != "beam":
            raise ValueError("beam_parallel needs beam mode "
                             f"(n_beams > 0, got mode={mode})")
        if mesh is not None and cfg.n_beams % mesh.shape[FX_AXIS]:
            raise ValueError(
                f"beam_parallel needs n_beams ({cfg.n_beams}) divisible "
                f"by the fx-axis size ({mesh.shape[FX_AXIS]})")

    if cfg.time_shards > 1:
        if max_delay:
            # mirror history_len's guard: the SP step carries per-shard
            # frame history only — silently ignoring max_delay would
            # skip the coarse alignment and return wrong visibilities
            raise ValueError(
                "time-sharded (SP) mode requires coarse delay on the "
                "host/ingest path (max_delay must be 0)")
        return _make_sp_step(cfg, window, mesh=mesh, donate=donate)

    def step(history, vis_acc, chunk, coarse, frac, phase, gains,
             weights, reset):
        buf = jnp.concatenate([history, chunk], axis=-1)
        delayed = coarse_delay(buf, coarse, max_delay) \
            if device_coarse \
            else (buf if max_delay == 0 else buf[..., max_delay:])
        q = f_engine(delayed, window, taps, n_chans,
                     frac_delay=frac if cfg.apply_delay else None,
                     phase=phase if cfg.apply_delay else None,
                     gains=gains if quantized else None)
        new_history = buf[..., chunk.shape[-1]:]
        outputs = {}
        if mode == "fengine":
            outputs["spectra"] = q
        elif mode == "fx":
            # integration carries the packed-triangle plane; extraction to
            # baselines happens once per dump in the runner (C8/C9)
            base = jax.lax.cond(reset, jnp.zeros_like, lambda a: a,
                                vis_acc)
            qk = jnp.moveaxis(corner_turn_all_to_all(q, FX_AXIS)
                              if mesh is not None else q, 3, 0)
            vis_acc = ops.xcorr_accumulate(base, qk)
        else:  # beam
            coh = ops.beamform(q, weights)
            if mesh is not None:
                if beam_parallel:
                    # EP: reduce-scatter the partial beams over the beam
                    # axis — each device ends with its 1/N beam subset
                    # fully reduced; Stokes/requant below then run on
                    # the local shard only (SURVEY.md §2.3, EP row)
                    coh = jax.lax.psum_scatter(
                        coh, FX_AXIS, scatter_dimension=0, tiled=True)
                else:
                    coh = jax.lax.psum(coh, FX_AXIS)
            if cfg.beam_stokes:
                # detection runs on the FLOAT beam voltages (before any
                # int8 beam quantisation); XLA fuses the elementwise
                # products into the beamformer output
                outputs["stokes"] = ops.stokes(coh)
            if cfg.beam_quant_scale:
                # int8 beam output (BASELINE.json:11 / SURVEY C10)
                coh = jnp.clip(
                    jnp.rint(coh * cfg.beam_quant_scale), -127, 127
                ).astype(jnp.int8)
            outputs["beams"] = coh
            if cfg.incoherent_beam:
                inc = ops.incoherent_sum(q)
                if mesh is not None:
                    inc = jax.lax.psum(inc, FX_AXIS)
                outputs["incoherent"] = inc
        return new_history, vis_acc, outputs

    if mesh is None:
        fn = step
    else:
        a = P(FX_AXIS)
        # fx mode carries the (k, ap, ap) packed accumulator sharded on
        # channels (axis 0); other modes carry a rank-1 dummy
        vis_spec = P(FX_AXIS) if mode == "fx" else P(None)
        # EP mode leaves beams (and the per-beam Stokes products)
        # sharded over the beam axis; the all-reduce mode replicates
        bspec = P(FX_AXIS) if beam_parallel else P()
        beam_out = {"beams": bspec}
        if cfg.beam_stokes:
            beam_out["stokes"] = bspec  # computed post-reduction
        if cfg.incoherent_beam:
            beam_out["incoherent"] = P()   # no beam axis: replicated
        out_specs = {"fengine": (a, vis_spec, {"spectra": a}),
                     "fx": (a, vis_spec, {}),
                     "beam": (a, vis_spec, beam_out)}[mode]
        fn = jax.shard_map(
            step, mesh=mesh,
            in_specs=(a, vis_spec, a, a, a, a, P(), P(None, FX_AXIS),
                      P()),
            out_specs=out_specs,
        )
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(fn, donate_argnums=donate_argnums)


def _make_sp_step(cfg: ChainConfig, window, *, mesh, donate: bool):
    """Sequence-parallel streaming step: the sample stream sharded over
    the ``time`` mesh axis (SURVEY.md §5 long-context row, first-class),
    COMPOSED with the ``fx`` axis of the same 2D mesh.

    Each chunk splits into ``time_shards`` contiguous segments.  Shard i
    prepends the overlap-save halo from shard i-1 (one ring ``ppermute``
    per chunk); shard 0 prepends the CARRIED history — the previous
    chunk's global stream tail, which is exactly what the ring delivers
    to shard 0 from shard n-1, so the carry update costs nothing extra
    and there is no cold start except at stream start (VERDICT r1 #5:
    round-1's one-shot ``make_time_sharded_fengine`` re-zeroed history
    every call).

    The fx axis composes per mode (SURVEY.md §2.3 parallelism table —
    these are the SP x DP / SP x TP / SP x EP products):

    * ``fengine``: antennas sharded over fx (SP x DP) — each device
      channelizes a (antenna-subset, time-segment) tile.
    * ``beam``: antennas sharded over fx; partial beams finish with a
      psum over fx per time shard — or, with ``cfg.beam_parallel``, a
      ``psum_scatter`` that leaves each device a fully-reduced 1/N beam
      subset of its time segment (SP x EP).
    * ``fx``: antennas sharded over fx before the corner-turn, channels
      after (SP x TP).  Each time shard integrates its stream segment
      into its OWN partial accumulator — the carry gains a leading
      time axis, sharded (time, fx) — and the dump-time extraction sums
      over time shards, so the cross-shard all-reduce rides the dump
      cadence, not the chunk cadence.
    """
    from dc_sand_tpu.parallel import TIME_AXIS

    mode = mode_for(cfg)
    if mesh is None or TIME_AXIS not in mesh.shape \
            or mesh.shape[TIME_AXIS] != cfg.time_shards:
        raise ValueError(
            f"SP mode needs a mesh with a {cfg.time_shards}-way "
            f"'{TIME_AXIS}' axis (build_mesh(time_shards=...))")
    fx_n = mesh.shape.get(FX_AXIS, 1)
    if cfg.n_ants % fx_n:
        raise ValueError(
            f"n_ants ({cfg.n_ants}) must divide over the fx axis "
            f"({fx_n}) when composing time_shards with an fx mesh")
    if mode == "fx" and cfg.n_chans % fx_n:
        raise ValueError(
            f"n_chans ({cfg.n_chans}) must divide over the fx axis "
            f"({fx_n}) for the SP fx corner-turn")
    beam_parallel = bool(cfg.beam_parallel) and mode == "beam"
    taps, n_chans = cfg.n_taps, cfg.n_chans
    quantized = cfg.apply_requant
    halo = cfg.history_len
    n = cfg.time_shards
    if cfg.chunk_samples % n or cfg.chunk_samples // n < halo:
        raise ValueError(
            f"chunk of {cfg.chunk_samples} samples cannot shard {n} "
            f"ways with an overlap-save halo of {halo}")

    def step(history, vis_acc, chunk, coarse, frac, phase, gains,
             weights, reset):
        # history/chunk/frac/phase arrive shard-local (fx x time axes)
        idx = jax.lax.axis_index(TIME_AXIS)
        tail = chunk[..., -halo:]
        ring = [(i, (i + 1) % n) for i in range(n)]
        halo_in = jax.lax.ppermute(tail, TIME_AXIS, ring)
        hist_block = jnp.where(idx == 0, history, halo_in)
        xh = jnp.concatenate([hist_block, chunk], axis=-1)
        q = f_engine(xh, window, taps, n_chans,
                     frac_delay=frac if cfg.apply_delay else None,
                     phase=phase if cfg.apply_delay else None,
                     gains=gains if quantized else None)
        # shard 0 received shard n-1's tail = the next chunk's carry;
        # other shards park zeros in their (dead) carry block
        new_history = jnp.where(idx == 0, halo_in,
                                jnp.zeros_like(halo_in))
        outputs = {}
        if mode == "fengine":
            outputs["spectra"] = q
        elif mode == "fx":
            # corner-turn over fx WITHIN this time shard: local antennas
            # x all channels -> all antennas x local channels; then the
            # in-place CMAC integrates into this time shard's partial
            # block accumulator (leading axis of the carry)
            qk = jnp.moveaxis(corner_turn_all_to_all(q, FX_AXIS), 3, 0)
            base = jax.lax.cond(reset, jnp.zeros_like, lambda a_: a_,
                                vis_acc)
            vis_acc = ops.xcorr_accumulate(base[0], qk)[None]
        else:  # beam
            coh = ops.beamform(q, weights)
            # (a psum over a 1-device fx axis is free, and states the
            # replication the out_specs declare)
            if beam_parallel:
                # SP x EP: fully-reduced 1/N beam subset per device
                # (same psum_scatter as the non-SP EP path)
                coh = jax.lax.psum_scatter(
                    coh, FX_AXIS, scatter_dimension=0, tiled=True)
            else:
                coh = jax.lax.psum(coh, FX_AXIS)
            if cfg.beam_stokes:
                # detection on the float beams, per time shard (purely
                # elementwise over the time-sharded spectra axis)
                outputs["stokes"] = ops.stokes(coh)
            if cfg.beam_quant_scale:
                coh = jnp.clip(
                    jnp.rint(coh * cfg.beam_quant_scale), -127, 127
                ).astype(jnp.int8)
            outputs["beams"] = coh
            if cfg.incoherent_beam:
                outputs["incoherent"] = jax.lax.psum(
                    ops.incoherent_sum(q), FX_AXIS)
        return new_history, vis_acc, outputs

    # (a, p, samples): antennas sharded over fx, samples over time
    t = P(FX_AXIS, None, TIME_AXIS)
    vis_spec = P(TIME_AXIS, FX_AXIS) if mode == "fx" else P(None)
    bspec = (P(FX_AXIS, None, TIME_AXIS) if beam_parallel
             else P(None, None, TIME_AXIS))
    if mode == "fengine":
        out_sp = {"spectra": t}
    elif mode == "fx":
        out_sp = {}
    else:
        out_sp = {"beams": bspec}
        if cfg.beam_stokes:
            out_sp["stokes"] = bspec   # (beam, 4, b-sharded, k)
        if cfg.incoherent_beam:
            out_sp["incoherent"] = P(None, TIME_AXIS)
    fn = jax.shard_map(
        step, mesh=mesh,
        in_specs=(t, vis_spec, t, P(), t, t, P(), P(None, FX_AXIS),
                  P()),
        out_specs=(t, vis_spec, out_sp),
    )
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(fn, donate_argnums=donate_argnums)
