"""End-to-end verification of the five evaluation configs (C16).

Each config runs through the real streaming runner and is compared
against the float64 golden chain at the contract bound of >50 dB SNR
(BASELINE.json:5).  ``verify_config`` returns {stage: snr_db}; the CLI
prints and grades them.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from dc_sand_tpu import golden
from dc_sand_tpu.config import get_config, scaled_for_test
from dc_sand_tpu.runtime import DelayModel, FXRunner
from dc_sand_tpu.utils import snr_db, np_ri2c
from dc_sand_tpu.windows import pfb_window

logger = logging.getLogger("dc_sand_tpu.verify")

SNR_BOUND = 50.0

# ``verify_config`` keywords of the production-cadence check (``cli verify
# <config> --production-cadence``): the config's own chunk/integration
# cadence (fx64: 2048-spectra chunks, 8192 per dump), golden graded on all
# pairs among a 12-antenna random subset — per-antenna float64 evaluation
# keeps the golden chain ~13 GB (the all-antenna chain at this cadence
# peaks >128 GB of host memory)
PRODUCTION_CADENCE = dict(spectra_per_chunk=None, n_spectra_per_acc=None,
                          golden_ants=12)

__all__ = ["verify_config", "SNR_BOUND", "PRODUCTION_CADENCE"]


def _golden_coarse_stream(cfg, stream, dm, n_chunks, ant_idx=None):
    """Per-chunk read-pointer coarse delay, replicating the runner's host
    feed path bitwise: chunk i is sliced from [zeros(md) | stream] at
    offset ``i*c + md - coarse_i`` with the coarse delay frozen at the
    chunk start.  (A single whole-stream coarse delay is only correct
    for a non-drifting model — this oracle stays right for d1 != 0.)

    ``ant_idx`` maps ``stream``'s (possibly subset) antenna axis to the
    delay model's original antenna indices."""
    md = dm.max_delay
    c_samp = cfg.chunk_samples
    xg = np.concatenate(
        [np.zeros(stream.shape[:-1] + (md,), stream.dtype), stream], -1)
    out = np.empty_like(stream)
    for i in range(n_chunks):
        coarse, _, _ = dm.evaluate_chunk(
            i * c_samp, cfg.spectra_per_chunk, cfg.fft_size)
        for idx in np.ndindex(stream.shape[:-1]):
            midx = ((int(ant_idx[idx[0]]),) + idx[1:]
                    if ant_idx is not None else idx)
            off = i * c_samp + md - int(coarse[midx])
            out[idx][i * c_samp:(i + 1) * c_samp] = xg[idx][off:off + c_samp]
    return out


def _golden_spectra(cfg, stream, dm, gains, n_chunks, window,
                    ant_idx=None):
    """Float64 golden F-engine spectra for ``stream``.

    ``ant_idx`` (optional): evaluate only these antennas (by original
    index into ``stream``/the delay model), ONE ANTENNA AT A TIME, so
    peak host memory is bounded by a single antenna's float64
    intermediates — at the fx64 production cadence (8192-spectra dumps,
    4k chans) the all-antenna chain peaks >128 GB and gets OOM-killed,
    which is exactly how the round-5 record refresh lost its
    production-cadence verify.  Returns spectra for ``ant_idx``'s
    antennas in that order (all antennas when None)."""
    fracs, phases = [], []
    for i in range(n_chunks):
        _, f, p = dm.evaluate_chunk(i * cfg.chunk_samples,
                                    cfg.spectra_per_chunk, cfg.fft_size)
        fracs.append(f)
        phases.append(p)
    frac = np.concatenate(fracs, -1) if cfg.apply_delay else None
    phase = np.concatenate(phases, -1) if cfg.apply_delay else None
    lead = (cfg.n_taps - 1) * cfg.fft_size

    def chain(sub, orig_ants):
        if cfg.apply_delay:
            sub = _golden_coarse_stream(cfg, sub, dm, n_chunks,
                                        ant_idx=orig_ants)
        xg = np.concatenate(
            [np.zeros(sub.shape[:-1] + (lead,)), sub], axis=-1)
        kw = dict(gains=gains if cfg.apply_requant else None)
        if cfg.apply_delay:
            kw.update(frac_delay=frac[orig_ants], phase=phase[orig_ants])
        return golden.f_engine(xg, window, cfg.n_taps, cfg.n_chans, **kw)

    if ant_idx is None:
        return chain(stream, np.arange(stream.shape[0]))
    return np.concatenate(
        [chain(stream[orig:orig + 1], np.array([orig]))
         for orig in ant_idx], axis=0)


def verify_config(name: str, *, n_chunks: int = 4, scale: Optional[int] = None,
                  mesh=None, seed: int = 0,
                  spectra_per_chunk: Optional[int] = 16,
                  n_spectra_per_acc: Optional[int] = 32,
                  time_shards: int = 1,
                  baseline_subset: Optional[int] = None,
                  golden_ants: Optional[int] = None,
                  beam_parallel: bool = False):
    """Run config ``name`` end-to-end; returns ``(snrs, counters)`` —
    per-output SNRs (dB) vs golden plus the runner's counters.

    ``scale``: optionally reduce n_chans (CPU-friendly); None = full size.
    ``mesh``: run the SPMD path over this mesh (config 4/5's sharded mode).
    ``spectra_per_chunk`` / ``n_spectra_per_acc``: clamp the streaming
    cadence for test-speed (defaults); pass ``None`` to run the config's
    own production cadence (e.g. fx64 at 8192 spectra per dump).
    ``baseline_subset``: compare only this many randomly-chosen
    baselines against golden — the float64 golden X-engine over ALL 2080
    baselines at production cadence costs about an hour on four host
    cores, while the SNR statistic over a random baseline subset x all
    channels (~10^6 values) is equivalent; the device side always
    computes everything.
    ``golden_ants``: restrict the graded baselines to ALL pairs among a
    random subset of this many antennas, and evaluate the float64
    golden spectra ONLY for those antennas (one at a time) — at the
    fx64 production cadence the all-antenna golden chain peaks >128 GB
    of float64 intermediates and gets OOM-killed; 12 antennas give 78
    baselines x 4 pol products x 4k channels (~1.3e6 graded values)
    within a ~13 GB golden footprint.  Mutually exclusive with
    ``baseline_subset``; the device still computes every baseline.
    """
    cfg = get_config(name)
    if scale is not None:
        cfg = scaled_for_test(cfg, n_chans=scale)
    if spectra_per_chunk is not None:
        cfg = cfg.replace(spectra_per_chunk=min(cfg.spectra_per_chunk,
                                                spectra_per_chunk))
    if n_spectra_per_acc is not None:
        cfg = cfg.replace(n_spectra_per_acc=min(cfg.n_spectra_per_acc,
                                                n_spectra_per_acc))
    if time_shards > 1:
        # SP mode: each time shard needs >= (taps-1) spectra of halo;
        # keep the dump window a multiple of the (possibly raised)
        # chunk so the fx-mode cadence guard below still holds
        spc = max(cfg.spectra_per_chunk, time_shards * cfg.n_taps)
        spa = -(-cfg.n_spectra_per_acc // spc) * spc
        cfg = cfg.replace(time_shards=time_shards,
                          spectra_per_chunk=spc, n_spectra_per_acc=spa)
    if beam_parallel:
        # EP mode (beam-sharded B-engine, psum_scatter reduction)
        cfg = cfg.replace(beam_parallel=True)
    if cfg.run_xengine and cfg.n_spectra_per_acc % cfg.spectra_per_chunk:
        # the runner dumps at chunk-aligned boundaries (>=), while the
        # golden oracle below slices exact n_spectra_per_acc windows —
        # a misaligned cadence would compare different integration
        # windows and report a silently wrong SNR
        raise ValueError(
            f"n_spectra_per_acc ({cfg.n_spectra_per_acc}) must be a "
            f"multiple of spectra_per_chunk ({cfg.spectra_per_chunk}) "
            "for fx verification")
    rng = np.random.default_rng(seed)
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)

    if cfg.apply_delay:
        dm = DelayModel.zeros(a, p, max_delay=32)
        dm.d0 = rng.integers(0, 32, (a, p)).astype(float)
        dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    else:
        dm = DelayModel.zeros(a, p)

    if name == "pfb1k":
        # config 1's contract input: a CW tone (BASELINE.json:7)
        k0 = k // 3
        tone = golden.cw_tone(n_chunks * cfg.chunk_samples,
                              k0 * cfg.sample_rate_hz / cfg.fft_size,
                              cfg.sample_rate_hz, amplitude=90.0)
        stream = golden.quantize_adc(
            np.broadcast_to(tone, (a, p) + tone.shape))
    else:
        # slab-wise generation (bit-identical to quantize_adc(
        # gaussian_noise(...))): the monolithic float64 path peaks
        # ~200 GB at the fx64 production cadence and OOMs this host
        stream = golden.gaussian_noise_int8(
            (a, p, n_chunks * cfg.chunk_samples), 20.0, seed)

    gains = np.full(k, 0.05) + 0j
    gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
    weights = None
    if cfg.n_beams:
        weights = rng.normal(size=(cfg.n_beams, a, k, 2)).astype(np.float32)

    # under a multi-PROCESS mesh each process feeds only its local
    # antennas, and coarse delay runs on DEVICE (the host-tail path is
    # single-process; production uses ingest placement).  The synthetic
    # sky is seeded identically everywhere so the golden oracle below
    # still sees the full array.
    import jax
    multiproc = mesh is not None and jax.process_count() > 1
    a_lo, a_hi = 0, a
    if multiproc:
        from dc_sand_tpu.parallel.distributed import local_antenna_range
        a_lo, a_hi = local_antenna_range(a)
    runner = FXRunner(cfg, window, delay_model=dm, gains=gains_ri,
                      weights=weights, mesh=mesh,
                      coarse_on_host=not multiproc)
    outputs = []
    dumps, counters = runner.run(
        lambda i: stream[a_lo:a_hi, :,
                         i * cfg.chunk_samples:(i + 1) *
                         cfg.chunk_samples],
        n_chunks, on_output=lambda i, o: outputs.append(o))

    if golden_ants is not None:
        if baseline_subset is not None:
            raise ValueError("golden_ants and baseline_subset are "
                             "mutually exclusive")
        if runner.mode != "fx":
            raise ValueError("golden_ants applies to fx-mode configs")
        ants_sel = np.sort(rng.choice(a, min(golden_ants, a),
                                      replace=False))
        spec_g = _golden_spectra(cfg, stream, dm, gains, n_chunks,
                                 window, ant_idx=ants_sel)
    else:
        ants_sel = None
        spec_g = _golden_spectra(cfg, stream, dm, gains, n_chunks,
                                 window)
    snrs: Dict[str, float] = {}
    if runner.mode == "fengine":
        # spectra ship as natural-order (a, p, b, K, 2) wire arrays
        got = np.concatenate([np.asarray(o["spectra"])
                              for o in outputs], axis=2)
        snrs["spectra"] = snr_db(spec_g, np_ri2c(got))
    elif runner.mode == "fx":
        bpa = cfg.n_spectra_per_acc
        pairs = golden.baseline_pairs(a)
        loc = None
        if ants_sel is not None:
            # all canonical baselines whose BOTH antennas are in the
            # golden subset, with spec_g positions local to the subset
            pos = {int(x): li for li, x in enumerate(ants_sel)}
            sel = [(bi, pos[int(i_)], pos[int(j_)])
                   for bi, (i_, j_) in enumerate(pairs)
                   if int(i_) in pos and int(j_) in pos]
            bl_idx = np.array([bi for bi, _, _ in sel])
            loc = [(li, lj) for _, li, lj in sel]
        elif baseline_subset is not None and baseline_subset < len(pairs):
            bl_idx = np.sort(rng.choice(len(pairs), baseline_subset,
                                        replace=False))
        else:
            bl_idx = None
        vals = []
        for i, d in enumerate(dumps):
            win = spec_g[:, :, i * bpa:(i + 1) * bpa]
            got = d.vis[..., 0] + 1j * d.vis[..., 1]
            if bl_idx is None:
                vals.append(snr_db(golden.xcorr(win), got))
            else:
                idx_pairs = (loc if loc is not None
                             else pairs[bl_idx])
                vg = np.stack([
                    np.einsum("pbk,qbk->pqk", win[i_], np.conj(win[j_]))
                    for (i_, j_) in idx_pairs])
                vals.append(snr_db(vg, got[bl_idx]))
        snrs["visibilities"] = min(vals) if vals else float("nan")
    else:  # beam
        wg = weights[..., 0] + 1j * weights[..., 1]
        beams_g = golden.beamform(spec_g, wg)
        spc = cfg.spectra_per_chunk

        def _addressable(x):
            return (not hasattr(x, "is_fully_addressable")
                    or x.is_fully_addressable)

        if all(_addressable(o["beams"]) for o in outputs):
            got_b = np.concatenate([np.asarray(o["beams"])
                                    for o in outputs], axis=2)
            snrs["beams"] = snr_db(beams_g, np_ri2c(got_b))
        else:
            # multi-host EP (beam_parallel): the runner deliberately
            # passes beams through as NON-fully-addressable arrays —
            # each process holds only its fully-reduced beam subset
            # after the psum_scatter.  Materialising them would raise
            # "spans non-addressable devices"; compare each addressable
            # shard against the matching golden beam slice instead
            # (the same per-shard grading as tests/_mp_fx_worker.py's
            # beam_ep leg).
            vals = []
            for i, o in enumerate(outputs):
                for s in o["beams"].addressable_shards:
                    idx = tuple(s.index)  # (beam, pol, b, k, 2) slices
                    ref = beams_g[idx[0], idx[1],
                                  i * spc:(i + 1) * spc, idx[3]]
                    vals.append(snr_db(ref, np_ri2c(np.asarray(s.data))))
            if not vals:
                raise RuntimeError(
                    "beam_parallel verify: no addressable beam shards "
                    "on this process")
            snrs["beams"] = min(vals)
        got_i = np.concatenate([np.asarray(o["incoherent"])
                                for o in outputs], axis=1)
        snrs["incoherent"] = snr_db(golden.incoherent_sum(spec_g), got_i)
    return snrs, counters
