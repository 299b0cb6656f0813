"""At-rate ingest -> runner benchmark (C15/C21, VERDICT r1 #8).

Drives the native C++ packet assembler exactly the way production would
— timestamped per-stream packets in, ``ingest_retire`` chunks out — and
measures the sustained host-side feed rate against one device's share of
the array's real-time rate (``bench.pipelines.realtime_share``), in two
stages:

* ``ingest_host`` — packets -> reassembled chunk -> (optionally) the
  runner's vectorised host coarse-delay gather.  This is the whole host
  feed path in front of the device step; if it cannot keep up, the
  device starves no matter how fast the kernels are.  With
  ``delay_in_ingest`` the coarse delay is applied for free at packet
  placement (NativeIngest.set_delay) and the host gather disappears —
  the production default.
* ``ingest_runner`` — the same feed driving ``FXRunner.run`` end to end
  (device step included); the JSON records the chunk count so the
  per-dispatch fixed cost is visible.
"""

from __future__ import annotations

import time

import numpy as np

from dc_sand_tpu.bench.harness import BenchResult
from dc_sand_tpu.bench.pipelines import realtime_share

__all__ = ["bench_ingest_host", "bench_ingest_runner",
           "bench_ingest_udp", "bench_e2e_atrate"]


def _make_bursts(a, p, c_samp, n_chunks, packet_samples, seed=0):
    """Per-chunk burst descriptors in NIC-ring shape: parallel
    (ant, pol, timestamp) arrays + one contiguous payload buffer per
    chunk (packet order (ant, pol, offset) IS the chunk layout, so the
    chunk's own bytes serve as the burst payload)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-100, 100, (a, p, n_chunks * c_samp),
                        dtype=np.int8)
    npk = c_samp // packet_samples
    ants = np.repeat(np.arange(a, dtype=np.int32), p * npk)
    pols = np.tile(np.repeat(np.arange(p, dtype=np.int32), npk), a)
    offs = np.tile(np.arange(npk, dtype=np.uint64) * packet_samples,
                   a * p)
    bursts = []
    for i in range(n_chunks):
        base = i * c_samp
        payload = np.ascontiguousarray(
            data[..., base:base + c_samp]).tobytes()
        # timestamps stay RELATIVE; the driver adds the global chunk
        # base so warm + timed passes form one monotonic stream (a
        # rewound timestamp is a LATE packet the assembler rightly
        # drops — an earlier version of this bench timed exactly that:
        # every timed-pass packet dropped at the window check, no
        # placement memcpy at all, ~40% over the real rate)
        bursts.append((ants, pols, offs, payload))
    return data, bursts


def bench_ingest_host(n_ants: int = 64, n_pols: int = 2,
                      n_chans: int = 1024, spectra: int = 64,
                      n_chunks: int = 8, packet_samples: int = 16384,
                      delay_in_ingest: bool = True, n_workers: int = 1,
                      max_delay: int = 64,
                      zero_copy: bool = False) -> BenchResult:
    """Host feed path: submit -> retire -> coarse delay, no device.

    ``n_workers > 1`` shards the antennas over that many independent
    ingest instances driven from threads — the production layout (one
    reassembler per antenna group / NIC queue; ctypes releases the GIL
    during the native burst, so workers genuinely overlap).  One full
    pass over the ring warms the slot pages before timing (first-touch
    page faults otherwise read as 10x the steady-state cost).

    ``zero_copy=True`` retires via ``retire_view`` (the production
    pattern: gaps zero-filled in place, NO chunk-sized copy out — the
    next consumer is the host->device transfer reading the slot
    directly), vs the copying ``retire``.
    """
    import threading

    from dc_sand_tpu.runtime.ingest import NativeIngest
    a, p = n_ants, n_pols
    if a % n_workers:
        raise ValueError(f"{a} antennas must divide over {n_workers}")
    aw = a // n_workers
    c_samp = spectra * 2 * n_chans
    rng = np.random.default_rng(1)
    delays = rng.integers(0, max_delay, (a, p))

    workers = []
    for w in range(n_workers):
        _, bursts = _make_bursts(aw, p, c_samp, n_chunks, packet_samples,
                                 seed=w)
        ing = NativeIngest(aw, p, c_samp, n_slots=4)
        if delay_in_ingest:
            for ai in range(aw):
                for pi in range(p):
                    ing.set_delay(ai, pi,
                                  int(delays[w * aw + ai, pi]), max_delay)
        workers.append((ing, bursts))

    def drive(w, timed_chunks):
        ing, bursts = workers[w]
        host_tail = np.zeros((aw, p, max_delay), np.int8)
        for i in timed_chunks:
            ants, pols, tss, payload = bursts[i % n_chunks]
            ing.submit_burst(ants, pols,
                             tss + np.uint64(i * c_samp), payload,
                             packet_samples)
            if zero_copy:
                chunk, _fill = ing.retire_view(force=True)
            else:
                chunk, _fill = ing.retire(force=True)
            if not delay_in_ingest:
                # the runner's vectorised host gather (runner.py)
                buf = np.concatenate([host_tail, chunk], axis=-1)
                win = np.lib.stride_tricks.sliding_window_view(
                    buf, c_samp, axis=-1)
                sel = (max_delay - delays[w * aw:(w + 1) * aw]
                       .astype(np.int64))[..., None, None]
                chunk = np.ascontiguousarray(
                    np.take_along_axis(win, sel, axis=2)[..., 0, :])
                host_tail = buf[..., -max_delay:]
            if zero_copy:
                # release only AFTER the view's last read (the gather
                # path above copies out of the slot)
                ing.release()

    # warm: one pass over every ring slot (page first-touch); the timed
    # pass continues the SAME timestamp stream so nothing is late
    n_warm = min(4, n_chunks)
    for w in range(n_workers):
        drive(w, range(n_warm))

    timed = range(n_warm, n_warm + n_chunks)
    t0 = time.perf_counter()
    if n_workers == 1:
        drive(0, timed)
    else:
        ts = [threading.Thread(target=drive, args=(w, timed))
              for w in range(n_workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    wall = time.perf_counter() - t0
    samples = a * p * c_samp * n_chunks
    rate = samples / wall
    # aggregate over ALL workers: a late-drop in any of them means the
    # measured rate skipped that worker's placement memcpys
    stats = {}
    for ing, _b in workers:
        for k, v in ing.stats().items():
            stats[k] = stats.get(k, 0) + v
    if stats.get("packets_late"):
        raise RuntimeError(
            f"ingest bench submitted late packets ({stats}); the "
            "measured rate would not include placement cost")
    name = f"ingest_host_{'placed' if delay_in_ingest else 'gather'}"
    if zero_copy:
        name += "_view"
    if n_workers > 1:
        name += f"_{n_workers}w"
    return BenchResult(
        name=name,
        metric="host ingest feed samples/s", value=rate, unit="samp/s",
        wall_s=wall / n_chunks, bytes_moved=samples,
        extra={"n_ants": a, "n_chans": n_chans, "spectra": spectra,
               "packet_samples": packet_samples,
               "delay_in_ingest": delay_in_ingest,
               "n_workers": n_workers, "n_chunks": n_chunks,
               "vs_realtime": rate / realtime_share(),
               "stats": stats},
    ).finish()


def bench_ingest_runner(n_ants: int = 16, n_pols: int = 2,
                        n_chans: int = 1024, spectra: int = 64,
                        n_chunks: int = 8,
                        packet_samples: int = 16384) -> BenchResult:
    """End to end: packets -> native ingest -> FXRunner (device step)."""
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.runtime import DelayModel, FXRunner
    from dc_sand_tpu.runtime.ingest import NativeIngest
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx64").replace(
        n_ants=n_ants, n_pols=n_pols, n_chans=n_chans,
        spectra_per_chunk=spectra, n_spectra_per_acc=spectra * 2)
    a, p, c_samp = n_ants, n_pols, cfg.chunk_samples
    md = 64
    data, bursts = _make_bursts(a, p, c_samp, n_chunks, packet_samples)
    ing = NativeIngest(a, p, c_samp, n_slots=4)
    dm = DelayModel.zeros(a, p, max_delay=md)
    rng = np.random.default_rng(1)
    dm.d0 = rng.integers(0, md, (a, p)).astype(float)
    # coarse rides packet placement (free); the runner sees coarse=0 and
    # applies only the fine-delay/fringe residual on device
    for ai in range(a):
        for pi in range(p):
            ing.set_delay(ai, pi, int(dm.d0[ai, pi]), md)
    rdm = DelayModel.zeros(a, p)
    rdm.d1 = dm.d1
    rdm.p1 = dm.p1
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    runner = FXRunner(cfg, window, delay_model=rdm)

    def source(i):
        # zero-copy feed: transfer the view to the device HERE (and
        # block — jnp.asarray may copy asynchronously) so the slot can
        # return to the ring before the next burst; the runner accepts
        # device-resident chunks directly
        ants, pols, tss, payload = bursts[i % n_chunks]
        ing.submit_burst(ants, pols, tss + np.uint64(i * c_samp),
                         payload, packet_samples)
        import jax
        import jax.numpy as jnp
        view = ing.retire_view(force=True)[0]
        chunk = jax.block_until_ready(jnp.asarray(view))
        ing.release()
        return chunk

    # warm through a FULL dump cadence: the first dump compiles the
    # extraction program, which must stay out of the timed chunks
    n_warm = cfg.n_spectra_per_acc // cfg.spectra_per_chunk + 1
    runner.run(source, n_warm)
    t0 = time.perf_counter()
    runner.run(source, n_chunks - 1)
    wall = time.perf_counter() - t0
    samples = a * p * c_samp * (n_chunks - 1)
    rate = samples / wall
    return BenchResult(
        name="ingest_runner_e2e",
        metric="ingest->runner samples/s", value=rate, unit="samp/s",
        wall_s=wall / (n_chunks - 1), bytes_moved=samples,
        extra={"n_ants": a, "n_chans": n_chans, "spectra": spectra,
               "n_chunks": n_chunks - 1,
               "vs_realtime": rate / realtime_share()},
    ).finish()


def bench_e2e_atrate(n_ants: int = 16, n_pols: int = 2,
                     n_chans: int = 4096, spectra: int = 2048,
                     n_chunks: int = 6, packet_samples: int = 16384,
                     verify: bool = True,
                     queue_depth: int = 2,
                     feed: str = "host") -> BenchResult:
    """THE at-rate rehearsal with the device in the loop (VERDICT r3
    #5): SPEAD packets -> ``NativeIngest`` -> host->device transfer ->
    ``FXRunner`` FX step on the device, with the host feed (packet
    assembly + h2d) of chunk i+1 OVERLAPPING the device compute of
    chunk i via a double-buffered feeder thread — SURVEY §7
    "overlapping host feed with device compute".  One record carries
    the sustained rate, the ingest loss counters, AND the golden
    verification verdict of every timed dump (``dumps_verified``).

    The default shape (16 ants dual-pol 4k chans) is chosen so the
    float64 golden FX chain over the timed window stays tractable on
    the host; the same harness runs the full 64-ant shape.

    ``feed="device_replay"`` (VERDICT r4 #8): pre-stage every chunk in
    device memory before the clock starts and replay them through the
    identical runner chunk loop — removing the host-to-device leg.
    Record this next to the ``feed="host"`` record, never instead of
    it: replay measures the device-side chunk loop, host measures the
    whole transport chain.
    """
    import queue as queue_mod
    import threading

    import jax
    import jax.numpy as jnp

    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.runtime import FXRunner
    from dc_sand_tpu.runtime.ingest import NativeIngest
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx64").replace(
        n_ants=n_ants, n_pols=n_pols, n_chans=n_chans,
        spectra_per_chunk=spectra, n_spectra_per_acc=2 * spectra,
        apply_delay=False)
    a, p, c_samp = n_ants, n_pols, cfg.chunk_samples
    # warm TWO full dump windows (step + extract programs both compile
    # there) and keep the timed region dump-aligned so the golden
    # windows line up
    cpd = cfg.n_spectra_per_acc // spectra
    if n_chunks % cpd:
        raise ValueError(f"n_chunks must be dump-aligned (x{cpd})")
    n_warm = 2 * cpd
    total = n_warm + n_chunks
    if feed not in ("host", "device_replay"):
        raise ValueError(f"feed must be 'host' or 'device_replay', "
                         f"got {feed!r}")
    data, bursts = _make_bursts(a, p, c_samp, total, packet_samples,
                                seed=5)
    ing = NativeIngest(a, p, c_samp, n_slots=4)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    # EQ gain scaled so the requantised noise spectra fill int8 without
    # saturating (the tests' standard 0.05 choice for +-100 ADC noise)
    eq = 0.05
    gains_ri = np.stack([np.full((n_chans,), eq, np.float32),
                         np.zeros((n_chans,), np.float32)], -1)
    runner = FXRunner(cfg, window, gains=gains_ri)

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=queue_depth)
    stop = threading.Event()
    th = None

    if feed == "device_replay":
        # every chunk lands on the device before the clock starts; `source`
        # then hands out the staged device arrays in stream order
        # (each used exactly once — donation-safe) so the timed region
        # is purely the runner's device chunk loop + dump fetch
        staged = [jax.device_put(np.ascontiguousarray(
            data[..., i * c_samp:(i + 1) * c_samp]))
            for i in range(total)]
        jax.block_until_ready(staged)
        seq = iter(staged)

        def source(i):
            return next(seq)
    else:
        def feeder():
            # the production receive path: packets land in the
            # assembler's ring, a completed chunk is retired zero-copy
            # and shipped to the device while the PREVIOUS chunk is
            # still computing
            for i in range(total):
                if stop.is_set():
                    return
                ants, pols, tss, payload = bursts[i]
                ing.submit_burst(ants, pols,
                                 tss + np.uint64(i * c_samp),
                                 payload, packet_samples)
                view = ing.retire_view(force=True)[0]
                chunk = jax.block_until_ready(jnp.asarray(view))
                ing.release()
                q.put((i, chunk))

        th = threading.Thread(target=feeder, daemon=True)
        th.start()

        def source(i):
            j, chunk = q.get()
            assert j == i, (j, i)
            return chunk

    dumps_all = []
    runner.run(source, n_warm, on_dump=dumps_all.append)
    t0 = time.perf_counter()
    dumps = []
    runner.run(source, n_chunks, on_dump=dumps.append)
    # the wall must include the LAST dump's device work: on_dump's
    # np.asarray already forces it, so perf_counter here is honest
    wall = time.perf_counter() - t0
    stop.set()
    if th is not None:
        th.join(timeout=10)
    samples = a * p * c_samp * n_chunks
    rate = samples / wall
    stats = ing.stats() if feed == "host" else {}

    verified = None
    snrs = []
    if verify and dumps:
        from dc_sand_tpu import golden
        from dc_sand_tpu.utils import snr_db
        # the runner enters the timed region with REAL history (the
        # warm chunks) — the golden lead-in is the true stream tail
        t_lo = n_warm * c_samp
        lead = data[..., t_lo - (cfg.n_taps - 1) * cfg.fft_size:t_lo]
        seg = np.concatenate(
            [lead, data[..., t_lo:(n_warm + n_chunks) * c_samp]], -1)
        spec_g = golden.f_engine(
            seg, window, cfg.n_taps, n_chans,
            gains=np.full(n_chans, eq) + 0j)
        bpa = cfg.n_spectra_per_acc
        verified = True
        for di, d in enumerate(dumps):
            ref = golden.xcorr(spec_g[:, :, di * bpa:(di + 1) * bpa])
            vis = d.vis[..., 0] + 1j * d.vis[..., 1]
            snr = float(snr_db(ref, vis))
            snrs.append(snr)
            verified = verified and snr > 50 \
                and d.n_spectra == d.n_spectra_nominal
    extra = {"n_ants": a, "n_chans": n_chans, "spectra": spectra,
             "n_chunks": n_chunks,
             "packet_samples": packet_samples,
             "feed": feed,
             "vs_realtime": rate / realtime_share(),
             "dumps_verified": verified,
             "dump_snrs_db": snrs,
             "dumps": len(dumps)}
    if feed == "host":
        extra.update(
            overlap=f"feeder thread, queue depth {queue_depth}",
            ingest_stats=stats)
    else:
        extra["transport_note"] = (
            "chunks pre-staged on the device and replayed — no "
            "per-chunk h2d; measures the device chunk loop + dump "
            "fetch; pair with the feed=host record for the transport "
            "chain")
    return BenchResult(
        name=("e2e_atrate" if feed == "host" else "e2e_atrate_replay"),
        metric="e2e SPEAD->ingest->device samples/s" if feed == "host"
        else "e2e device-replay samples/s", value=rate,
        unit="samp/s", wall_s=wall / n_chunks, bytes_moved=samples,
        extra=extra,
    ).finish()


def bench_ingest_udp(n_ants: int = 8, n_pols: int = 2,
                     n_chans: int = 1024, spectra: int = 64,
                     n_chunks: int = 8, max_payload: int = 8192,
                     n_workers: int = 1) -> BenchResult:
    """The REAL wire leg (VERDICT r2 missing #2): SPEAD datagrams
    through an actual localhost UDP socket — ``SpeadTransmitter`` ->
    ``sendmmsg`` sink -> kernel loopback -> ``recvmmsg`` receiver
    thread -> ``NativeIngest`` -> retire.  Measures the sustained
    through-the-socket feed rate with loss counters live; packetization
    cost is included on the tx side (it is part of any real sender).

    ``n_workers`` shards antennas over that many (socket, receiver,
    assembler) triples — the production one-receiver-per-NIC-queue
    layout.  Localhost loopback bounds what one kernel socket pair can
    do; on deployment hardware the same code rides the NIC.
    """
    import threading

    from dc_sand_tpu.runtime.ingest import (NativeIngest,
                                            SpeadTransmitter,
                                            UdpSpeadReceiver,
                                            UdpSpeadSink)
    a, p = n_ants, n_pols
    if a % n_workers:
        raise ValueError(f"{a} antennas must divide over {n_workers}")
    aw = a // n_workers
    c_samp = spectra * 2 * n_chans
    rng = np.random.default_rng(3)
    data = rng.integers(-100, 100, (a, p, c_samp), dtype=np.int8)

    workers = []
    for w in range(n_workers):
        ing = NativeIngest(aw, p, c_samp, n_slots=4)
        rx = UdpSpeadReceiver(ing, bind_addr="127.0.0.1",
                              rcvbuf_bytes=64 * 1024 * 1024)
        sink = UdpSpeadSink("127.0.0.1", rx.port,
                            sndbuf_bytes=64 * 1024 * 1024)
        tx = SpeadTransmitter(sink, max_payload=max_payload)
        workers.append((ing, rx, sink, tx))

    def drive(w, chunks):
        ing, rx, sink, tx = workers[w]
        lo = w * aw
        for i in chunks:
            for ai in range(aw):
                for pi in range(p):
                    tx.send(data[lo + ai, pi], timestamp=i * c_samp,
                            stream=ai * p + pi)
            # real-time semantics: retire whatever arrived (the fill
            # statistic carries any socket loss); wait only for the
            # receiver to drain what the kernel actually delivered
            want = sink.stats()["datagrams"]
            t0 = time.perf_counter()
            while (rx.stats()["datagrams"] < want
                   and time.perf_counter() - t0 < 2.0):
                time.sleep(0)
            ing.retire_view(force=True)
            ing.release()

    n_warm = min(2, n_chunks)
    for w in range(n_workers):
        drive(w, range(n_warm))

    timed = range(n_warm, n_warm + n_chunks)
    t0 = time.perf_counter()
    if n_workers == 1:
        drive(0, timed)
    else:
        ts = [threading.Thread(target=drive, args=(w, timed))
              for w in range(n_workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    wall = time.perf_counter() - t0
    samples = a * p * c_samp * n_chunks
    rate = samples / wall
    stats = {"rx": {}, "tx": {}, "ingest": {}}
    for ing, rx, sink, _tx in workers:
        for k, v in rx.stats().items():
            stats["rx"][k] = stats["rx"].get(k, 0) + v
        for k, v in sink.stats().items():
            stats["tx"][k] = stats["tx"].get(k, 0) + v
        for k, v in ing.stats().items():
            stats["ingest"][k] = stats["ingest"].get(k, 0) + v
    for ing, rx, sink, _tx in workers:
        rx.close()
        sink.close()
    name = "ingest_udp" + (f"_{n_workers}w" if n_workers > 1 else "")
    return BenchResult(
        name=name,
        metric="UDP-socket ingest feed samples/s", value=rate,
        unit="samp/s", wall_s=wall / n_chunks, bytes_moved=samples,
        extra={"n_ants": a, "n_chans": n_chans, "spectra": spectra,
               "max_payload": max_payload, "n_workers": n_workers,
               "n_chunks": n_chunks,
               "vs_realtime": rate / realtime_share(),
               "stats": stats},
    ).finish()
