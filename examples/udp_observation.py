#!/usr/bin/env python
"""End-to-end observation over a REAL UDP socket (the wire leg).

`examples/spead_loopback.py` exercises the SPEAD framing in-process;
this demo puts the same signal chain on an actual kernel socket pair —
the deployment shape (SURVEY.md §2.1 transport tier, §3.2 network
boundaries), scaled to localhost:

  digitiser streams -> SpeadTransmitter -> UdpSpeadSink (sendmmsg)
      -> 127.0.0.1 UDP -> UdpSpeadReceiver (recvmmsg thread)
      -> NativeIngest -> FXRunner -> visibility dumps
      -> SpeadTransmitter -> second UDP hop -> downstream consumer

Loss counters are live at every hop; the retired chunks and the
delivered dump are verified bit-exact.

Runs anywhere: ``python examples/udp_observation.py``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def _drain(rx, want, timeout=5.0):
    t0 = time.monotonic()
    while rx.stats()["placed"] < want and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    return rx.stats()


def main() -> int:
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.runtime import (FXRunner, NativeIngest,
                                     SpeadTransmitter)
    from dc_sand_tpu.runtime.ingest import UdpSpeadReceiver, UdpSpeadSink
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx4").replace(n_chans=128, spectra_per_chunk=8,
                                    n_spectra_per_acc=16,
                                    apply_delay=False)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    n_chunks = 2
    rng = np.random.default_rng(11)
    x = rng.integers(-100, 100, (a, p, n_chunks * c), dtype=np.int8)

    # --- the antenna->correlator hop: a real socket pair --------------
    ing = NativeIngest(a, p, c)
    rx = UdpSpeadReceiver(ing, bind_addr="127.0.0.1")
    sink = UdpSpeadSink("127.0.0.1", rx.port)
    dig = SpeadTransmitter(sink, max_payload=2048)

    def source(i):
        # each "digitiser" ships its chunk over the wire, the receiver
        # thread reassembles, the runner retires at its own cadence
        for ai in range(a):
            for pi in range(p):
                dig.send(x[ai, pi, i * c:(i + 1) * c], timestamp=i * c,
                         stream=ai * p + pi)
        _drain(rx, sink.stats()["datagrams"])
        chunk, fill = ing.retire(force=True)
        assert fill == 1.0, f"socket lost data (fill {fill})"
        assert (chunk == x[:, :, i * c:(i + 1) * c]).all()
        return chunk

    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size))
    t0 = time.perf_counter()
    dumps, counters = runner.run(source, n_chunks)
    wall = time.perf_counter() - t0
    rate = a * p * c * n_chunks / wall

    # --- the correlator->consumer hop: a second socket pair -----------
    vis = np.ascontiguousarray(dumps[0].vis)
    consumer = NativeIngest(1, 1, vis.nbytes)
    rx2 = UdpSpeadReceiver(consumer, bind_addr="127.0.0.1")
    sink2 = UdpSpeadSink("127.0.0.1", rx2.port)
    out_tx = SpeadTransmitter(sink2, max_payload=4096)
    n_out = out_tx.send(vis.view(np.int8), timestamp=0, stream=0)
    _drain(rx2, n_out)
    got, fill2 = consumer.retire()
    ok = (fill2 == 1.0 and np.asarray(got).tobytes() == vis.tobytes()
          and rx.stats()["rejected"] == 0
          and sink.stats()["dropped"] == 0)

    print(f"rx: {rx.stats()}  tx: {sink.stats()}")
    print(f"{counters.chunks_in} chunks through the socket at "
          f"{rate / 1e6:.1f} Msamp/s (localhost), {len(dumps)} dumps; "
          f"dump delivered downstream bit-exact over hop 2 "
          f"({n_out} datagrams)")
    for h in (rx, sink, rx2, sink2):
        h.close()
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
