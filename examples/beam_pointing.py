#!/usr/bin/env python
"""Multi-beam beamformer pointing demo on one device.

A plane wave arrives from a direction that imposes a per-antenna phase
gradient; three beams are steered at different gradients.  The beam
whose steering matches the arrival direction collects ~N_ant^2 x the
power of the mis-steered beams — the B-engine's core physics
(SURVEY.md C10, config 5).  Runs anywhere:
``python examples/beam_pointing.py``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def main() -> int:
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.golden.sources import cw_tone, quantize_adc
    from dc_sand_tpu.models.steering import steering_weights
    from dc_sand_tpu.runtime import DelayModel, FXRunner
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("beam64").replace(
        n_ants=8, n_pols=1, n_chans=256, n_beams=3,
        spectra_per_chunk=16, n_spectra_per_acc=16, apply_delay=False,
        beam_quant_scale=0.0)
    a, k = cfg.n_ants, cfg.n_chans

    # plane wave: per-antenna phase gradient (sub-sample geometric
    # delay tau = slope * ant at the tone frequency)
    # slope: per-antenna arrival delay (samples).  At f = 64/512
    # cycles/sample this is a 2*pi/8 phase step per antenna - the
    # mis-steered beams' phasors walk the full circle and cancel.
    tone_chan, slope = 64, 1.0
    f_norm = tone_chan / k / 2
    t_total = cfg.chunk_samples
    x = np.stack([
        [quantize_adc(cw_tone(t_total, f_norm, 1.0, amplitude=60.0,
                              phase=2 * np.pi * f_norm * slope * ai))]
        for ai in range(a)])

    # beam 1 steered AT the wave (conjugate of the arrival phase:
    # steering delay -slope per antenna); beams 0/2 mis-steered.
    # sample_rate=1 puts channel k at f = k/(2K) cycles/sample, matching
    # the per-sample delay units used above.
    delays = np.stack([s * np.arange(a)
                       for s in (slope, -slope, -3 * slope)])
    w = steering_weights(delays, k, 1.0)            # (3, A, K, 2) f32

    beams = {}

    def on_output(i, outs):
        beams["coh"] = np.asarray(outs["beams"])    # (3, P, B, K, 2)

    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                      delay_model=DelayModel.zeros(a, 1),
                      weights=w)
    runner.run(lambda i: x, 1, on_output=on_output)

    coh = beams["coh"]
    power = (coh[..., 0] ** 2 + coh[..., 1] ** 2)[:, 0, :, tone_chan]
    power = power.mean(axis=1)                      # (3,)
    ratio = power[1] / max(power[0], power[2])
    print(f"beam powers at tone channel: {power}")
    print(f"on-source / best off-source ratio: {ratio:.1f} "
          "(mis-steered phasors walk the full circle and cancel)")
    ok = bool(power[1] > 10 * max(power[0], power[2]))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
