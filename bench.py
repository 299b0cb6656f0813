#!/usr/bin/env python
"""Headline benchmark: prints ONE JSON line.

Metric: channelized samples/s of the full F-engine (PFB-FIR + FFT +
fine-delay/fringe + 8-bit requant) on the local GPU — BASELINE.json:2
primary metric 1 — at 4096 channels, the channel count configs 2/4/5
(BASELINE.json:8,10,11) run.  ``vs_baseline`` is the ratio to one
device's share of the array's real-time rate (64 antennas x 2 pols x
1712 Msps = 219.1 Gsamp/s, ``bench.pipelines.realtime_share``).  The
1k-channel rate and the X-engine CMAC rate at the fx64 chunk ride along
in ``extra``; every number is measured in this run.  A machine with no
accelerator fails instead of printing a number.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax

    from dc_sand_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py: no accelerator found (platform cpu)",
              file=sys.stderr)
        return 2
    from dc_sand_tpu.bench.kernels import bench_xcorr
    from dc_sand_tpu.bench.pipelines import bench_fengine, realtime_share
    from dc_sand_tpu.config import get_config

    res = bench_fengine(n_streams=16, n_spectra=512, n_chans=4096,
                        taps=16, full_chain=True)
    res1k = bench_fengine(n_streams=16, n_spectra=512, n_chans=1024,
                          taps=16, full_chain=True)
    xr = bench_xcorr(n_spectra=get_config("fx64").spectra_per_chunk)
    print(json.dumps({
        "metric": res.metric + " (4k chans)",
        "value": res.value,
        "unit": res.unit,
        "vs_baseline": res.value / realtime_share(),
        "extra": {"device_kind": dev.device_kind,
                  "gsamp_s_1k_chans": res1k.value / 1e9,
                  "hbm_roofline_frac": res.hbm_roofline_frac,
                  "xcorr_baselines_per_s_64ant": xr.value,
                  "xcorr_int8_tops": xr.extra["int8_tops"],
                  "xcorr_n_spectra": xr.extra["n_spectra"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
