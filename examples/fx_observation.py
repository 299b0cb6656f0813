#!/usr/bin/env python
"""Minimal FX-correlator observation, end to end on one device.

A 4-antenna dual-pol synthetic observation: a common-sky CW tone with
per-antenna geometric delays -> streaming runner (coarse delay on the
host feed path, fine delay + fringe rotation on device) -> integrated
visibilities.  Verifies that after delay/fringe correction the
baseline phases close to ~zero — the correlator's end-to-end physics
check (SURVEY.md §4.2, same spirit as the reference's per-experiment
harnesses).

Runs anywhere (CPU included): ``python examples/fx_observation.py``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def main() -> int:
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.golden.chain import baseline_pairs
    from dc_sand_tpu.golden.sources import cw_tone, quantize_adc
    from dc_sand_tpu.runtime import DelayModel, FXRunner
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx4").replace(n_chans=256, spectra_per_chunk=16,
                                    n_spectra_per_acc=32)
    a, p = cfg.n_ants, cfg.n_pols
    md = 32                       # coarse-delay lead-in (samples)
    rng = np.random.default_rng(0)

    # One sky signal, re-sampled per antenna at its geometric delay.
    # Convention (matches a real correlator delay model): ``d0`` is the
    # COMPENSATING delay the correlator applies — the stream is read
    # d samples back — so an antenna with model delay d sees the
    # wavefront d samples EARLY.
    n_chunks = 2
    t_total = n_chunks * cfg.chunk_samples
    tone_chan = 37.25             # off-bin: exercises leakage + phase
    f_norm = tone_chan / cfg.n_chans / 2
    delays = rng.integers(0, md, (a, p))
    sky = quantize_adc(cw_tone(t_total + md, f_norm, 1.0,
                               amplitude=80.0))
    x = np.stack([[sky[delays[ai, pi]:delays[ai, pi] + t_total]
                   for pi in range(p)] for ai in range(a)])

    dm = DelayModel.zeros(a, p, max_delay=md)
    dm.d0 = delays.astype(float)  # the correlator re-aligns the early arrivals
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                      delay_model=dm)
    dumps, counters = runner.run(
        lambda i: x[..., i * cfg.chunk_samples:
                    (i + 1) * cfg.chunk_samples], n_chunks)

    vis = dumps[0].vis            # (n_bl, P, P, K, 2) int32
    k = int(np.round(tone_chan))
    pairs = baseline_pairs(a)
    cross = [bl for bl, (i, j) in enumerate(pairs) if i != j]
    v = vis[cross, 0, 0, k, 0] + 1j * vis[cross, 0, 0, k, 1]
    phase_err = np.abs(np.angle(v))
    print(f"tone channel {k}: |vis| = {np.abs(v).mean():.3e}, "
          f"max residual baseline phase = {phase_err.max():.4f} rad")
    ok = bool((np.abs(v) > 0).all() and phase_err.max() < 0.05)
    print("PASS" if ok else "FAIL",
          f"({counters.chunks_in} chunks, {len(dumps)} dump)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
