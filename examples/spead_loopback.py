#!/usr/bin/env python
"""SPEAD-64-48 transport loopback: digitiser packets in, dumps out.

The reference world moves every hop as SPEAD heaps over UDP multicast
(SURVEY.md §2.1 transport tier).  This demo exercises the framework's
native C++ transport both ways with no network:

  tx side: per-antenna sample streams packetized by ``spead_packetize``
  rx side: datagrams (shuffled, as UDP would) -> ``NativeIngest``
           -> chunk -> FXRunner -> integrated visibility dump
  out:     the dump shipped onward by ``SpeadTransmitter``

Runs anywhere: ``python examples/spead_loopback.py``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def main() -> int:
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.runtime import (DelayModel, FXRunner, NativeIngest,
                                     SpeadTransmitter, spead_packetize)
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx4").replace(n_chans=128, spectra_per_chunk=8,
                                    n_spectra_per_acc=8,
                                    apply_delay=False)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    rng = np.random.default_rng(7)
    x = rng.integers(-100, 100, (a, p, c), dtype=np.int8)

    # --- tx: packetize every stream, shuffle the datagrams like UDP ---
    frags = []
    for ai in range(a):
        for pi in range(p):
            buf, lens = spead_packetize(x[ai, pi], timestamp=0,
                                        stream=ai * p + pi,
                                        heap_id=ai * p + pi,
                                        max_payload=1024)
            off = 0
            for ln in lens:
                frags.append(buf[off:off + int(ln)])
                off += int(ln)
    rng.shuffle(frags)

    # --- rx: reassemble, run the correlator on the retired chunk ------
    ing = NativeIngest(a, p, c)
    placed = ing.submit_spead_burst(frags)
    chunk, fill = ing.retire()
    assert fill == 1.0 and (chunk == x).all(), "transport corrupted data"

    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                      delay_model=DelayModel.zeros(a, p))
    dumps, counters = runner.run(lambda i: chunk, 1)

    # --- onward: ship the dump as SPEAD too ---------------------------
    sent = []
    tx = SpeadTransmitter(lambda b, l: sent.append((b, l)),
                          ticks_per_chunk=cfg.chunk_samples)
    n_pkts = tx.send_dump(dumps[0])
    print(f"{placed} datagrams in -> chunk reassembled bit-exact -> "
          f"{len(dumps)} dump ({dumps[0].vis.shape} int32) -> "
          f"{n_pkts} datagrams out")
    ok = placed == len(frags) and len(dumps) == 1 and n_pkts > 0
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
