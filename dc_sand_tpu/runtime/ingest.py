"""ctypes wrapper for the native ingest library (csrc/ingest.cpp).

Packet reassembly + 10-bit unpack in C++ (the reference's ingest tier is
C++ spead2/GPUDirect experiments); this wrapper exposes it as a chunk
``source`` for :class:`dc_sand_tpu.runtime.FXRunner`.  The library builds
on demand with ``make`` on first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = ["NativeIngest", "load_library", "unpack_10bit",
           "multi_ingest_source", "spead_packetize",
           "SpeadTransmitter", "UdpSpeadReceiver", "UdpSpeadSink"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Load (building if needed) libingest.so."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.join(_CSRC, "libingest.so")
    src = os.path.join(_CSRC, "ingest.cpp")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        subprocess.run(["make", "-C", _CSRC], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(so)
    lib.ingest_create.restype = ctypes.c_void_p
    lib.ingest_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int]
    lib.ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_submit.restype = ctypes.c_int
    lib.ingest_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.ingest_submit_burst.restype = ctypes.c_longlong
    lib.ingest_submit_burst.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
    lib.ingest_retire.restype = ctypes.c_longlong
    lib.ingest_retire.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int8),
                                  ctypes.c_int]
    lib.ingest_retire_view.restype = ctypes.c_longlong
    lib.ingest_retire_view.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int]
    lib.ingest_release.argtypes = [ctypes.c_void_p]
    lib.ingest_tail_complete.restype = ctypes.c_int
    lib.ingest_tail_complete.argtypes = [ctypes.c_void_p]
    lib.ingest_submit_spead.restype = ctypes.c_longlong
    lib.ingest_submit_spead.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ingest_submit_spead_burst.restype = ctypes.c_longlong
    lib.ingest_submit_spead_burst.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ingest_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.spead_encode.restype = ctypes.c_longlong
    lib.spead_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64]
    lib.ingest_set_delay.restype = ctypes.c_int
    lib.ingest_set_delay.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong]
    lib.unpack_10bit.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int8),
                                 ctypes.c_uint64]
    lib.udp_rx_create.restype = ctypes.c_void_p
    lib.udp_rx_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.udp_rx_port.restype = ctypes.c_int
    lib.udp_rx_port.argtypes = [ctypes.c_void_p]
    lib.udp_rx_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.udp_rx_destroy.argtypes = [ctypes.c_void_p]
    lib.udp_tx_create.restype = ctypes.c_void_p
    lib.udp_tx_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int]
    lib.udp_tx_send_burst.restype = ctypes.c_longlong
    lib.udp_tx_send_burst.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
    lib.udp_tx_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 3
    lib.udp_tx_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def unpack_10bit(packed: bytes, n_samples: int) -> np.ndarray:
    """Unpack 10-bit big-endian samples to int8 (drops 2 LSBs)."""
    lib = load_library()
    out = np.empty(n_samples, np.int8)
    lib.unpack_10bit(packed,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                     n_samples)
    return out


def multi_ingest_source(ingests, force: bool = True):
    """Runner ``source`` over N assemblers sharding the antenna axis —
    the production layout (one :class:`NativeIngest` per NIC queue /
    antenna group, each fed from its own receiver thread), with coarse
    delay placed at the packet boundary (``set_delay``).

    Each call retires one chunk VIEW per assembler (zero-copy),
    transfers each view to the device, and concatenates along the
    leading axis THERE — the full chunk is never materialised on the
    host, so the host-side cost stays at N slot-buffer transfers.  The
    previous call's slots are released first (the transfer is
    synchronous, so the device owns the bytes by then).
    """
    import jax
    import jax.numpy as jnp

    def source(_chunk_idx: int):
        if not force:
            # check ALL workers before retiring ANY: a retire that fails
            # midway would consume chunks from the earlier ingests and
            # desynchronise the workers by one chunk
            for ing in ingests:
                if not ing.tail_complete():
                    raise RuntimeError(
                        "multi_ingest_source(force=False): a worker's "
                        "tail chunk is incomplete")
        parts = []
        borrowed = []
        try:
            for ing in ingests:
                view, _fill = ing.retire_view(force=force)
                if view is None:
                    raise RuntimeError(
                        "multi_ingest_source(force=False): a worker's "
                        "tail chunk is incomplete")
                borrowed.append(ing)
                parts.append(jnp.asarray(view))
        finally:
            # the transfers MUST complete before the slots return to
            # the ring: jnp.asarray may copy asynchronously, and a
            # released slot can be overwritten by the receiver threads
            # immediately.  Release in a finally so a failed retire
            # (incomplete tail with force=False) cannot leave earlier
            # ingests' slots lent out forever.
            jax.block_until_ready(parts)
            for ing in borrowed:
                ing.release()
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts,
                                                                axis=0)

    return source


def spead_packetize(payload, timestamp: int, stream: int, *,
                    heap_id: int = 0, max_payload: int = 8192,
                    ts_id: int = 0x1600, stream_id: int = 0x3101,
                    align: int = 1):
    """Packetize one heap into SPEAD-64-48 datagrams (native encoder,
    ``csrc/ingest.cpp:spead_encode`` — the transmit mirror of
    :meth:`NativeIngest.submit_spead`).

    ``payload`` is any bytes-like / contiguous ndarray (an int8 stream
    chunk, a visibility dump's raw bytes); it is split into packets of
    at most ``max_payload`` payload bytes, each self-describing via
    immediate items (heap id, payload offset/length, ``ts_id``
    timestamp, ``stream_id`` stream index).  Returns ``(buf, lens)``:
    datagrams stored back to back — the exact burst shape
    :meth:`NativeIngest.submit_spead_burst` (loopback tests) or a
    ``sendmmsg()`` UDP loop (deployment) consumes.

    ``align`` forces payload split points to multiples of that many
    bytes: 10-bit packed streams (4 samples / 5 bytes) must pass
    ``align=5`` — the decoder rejects heaps split off a group boundary.
    """
    lib = load_library()
    if align > 1:
        if max_payload < align:
            raise ValueError(f"max_payload {max_payload} < align {align}")
        max_payload -= max_payload % align
    # zero-copy view of the payload; the only copy on this path is the
    # packet build itself (native memcpy into the datagram buffer)
    data = np.ascontiguousarray(
        np.frombuffer(memoryview(payload).cast("B"), np.uint8)
        if not isinstance(payload, np.ndarray)
        else payload.reshape(-1).view(np.uint8))
    n_pkts = -(-len(data) // max_payload)
    hdr = 8 + 8 * 6
    buf = ctypes.create_string_buffer(hdr * n_pkts + len(data))
    lens = np.empty(n_pkts, np.uint64)
    n = lib.spead_encode(
        buf, len(buf), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_pkts, data.ctypes.data_as(ctypes.c_char_p), len(data),
        heap_id, timestamp, stream, ts_id, stream_id, max_payload)
    if n < 0:
        raise ValueError("spead_encode: empty payload or capacity bug")
    return buf.raw, lens[:n]


class SpeadTransmitter:
    """Outward SPEAD sender for the signal chain's products (the
    reference world ships visibility dumps / beam data downstream as
    SPEAD heaps over UDP multicast; SURVEY.md §3.2 network boundary).

    Packetizes each array it is given as one heap per stream with a
    monotonically increasing heap id, and hands the datagram burst to
    ``sink(buf, lens)`` — a UDP ``sendmmsg`` loop in deployment, or an
    :class:`NativeIngest` loopback in tests.  Transport only: no
    device work, no copies beyond the packet build.
    """

    def __init__(self, sink, *, max_payload: int = 8192,
                 ts_id: int = 0x1600, stream_id: int = 0x3101,
                 ticks_per_chunk: int = 1):
        self._sink = sink
        self._max_payload = max_payload
        self._ids = (ts_id, stream_id)
        self._ticks_per_chunk = ticks_per_chunk
        self._heap = 0
        self.heaps_sent = 0

    def send(self, payload, timestamp: int, stream: int = 0) -> int:
        """Ship one heap; returns the number of datagrams emitted."""
        buf, lens = spead_packetize(
            payload, timestamp, stream, heap_id=self._heap,
            max_payload=self._max_payload, ts_id=self._ids[0],
            stream_id=self._ids[1])
        self._heap += 1
        self.heaps_sent += 1
        self._sink(buf, lens)
        return len(lens)

    def send_dump(self, dump) -> int:
        """Ship a runner :class:`~dc_sand_tpu.runtime.runner.Dump`:
        visibilities (stream 0) and, when present, beam data (stream 1).
        The 0x1600 timestamp convention is ADC sample ticks (exactly
        what the decode side assumes: sample index = timestamp +
        offset), so the dump's first chunk index is scaled by
        ``ticks_per_chunk`` — pass ``cfg.chunk_samples`` to place dumps
        on the stream's own timeline."""
        ts = int(getattr(dump, "first_chunk", 0)) * self._ticks_per_chunk
        n = self.send(np.ascontiguousarray(dump.vis), ts, 0)
        beams = getattr(dump, "beams", None)
        if beams is not None:
            n += self.send(np.ascontiguousarray(beams), ts, 1)
        return n


class NativeIngest:
    """Chunk assembler: submit timestamped packets, retire (A,P,C) chunks.

    Usage as a runner source::

        ing = NativeIngest(cfg.n_ants, cfg.n_pols, cfg.chunk_samples)
        ... feed packets (e.g. from a socket thread) via ing.submit(...)
        runner.run(lambda i: ing.retire(force=True)[0], n_chunks)
    """

    FORMAT_INT8 = 0
    FORMAT_10BIT = 1

    def __init__(self, n_ants: int, n_pols: int, chunk_samples: int,
                 n_slots: int = 4):
        self._lib = load_library()
        self._shape = (n_ants, n_pols, chunk_samples)
        self._h = ctypes.c_void_p(self._lib.ingest_create(
            n_ants, n_pols, chunk_samples, n_slots))
        if not self._h:
            raise ValueError(
                f"bad ingest geometry: n_ants={n_ants}, n_pols={n_pols},"
                f" chunk_samples={chunk_samples}, n_slots={n_slots} "
                "(all must be positive)")

    def set_delay(self, ant: int, pol: int, delay: int,
                  max_delay: int) -> None:
        """Coarse delay as packet-placement offset (C2's production
        home): stream samples land ``delay`` later on the aligned
        timeline; ``max_delay`` reserves the common lead-in."""
        r = self._lib.ingest_set_delay(self._h, ant, pol, delay, max_delay)
        if r != 0:
            raise ValueError(
                f"bad delay {delay} (max {max_delay}) for ({ant},{pol})")

    def submit(self, ant: int, pol: int, timestamp: int,
               payload: bytes, n_samples: Optional[int] = None,
               fmt: int = FORMAT_INT8) -> int:
        if n_samples is None:
            if fmt == self.FORMAT_10BIT:
                n_samples = len(payload) * 8 // 10
            else:
                n_samples = len(payload)
        return self._lib.ingest_submit(self._h, ant, pol, timestamp,
                                       payload, n_samples, fmt)

    def submit_burst(self, ants: np.ndarray, pols: np.ndarray,
                     timestamps: np.ndarray, payloads,
                     samples_per_packet: int,
                     fmt: int = FORMAT_INT8) -> int:
        """Submit a burst of equal-size packets in ONE native call.

        ``ants``/``pols`` int32, ``timestamps`` uint64 (parallel arrays,
        one entry per packet); ``payloads`` the packets' bytes stored
        contiguously.  This is the NIC-ring shape a real receiver hands
        over; per-packet Python calls cost ~35 us each in ctypes
        overhead alone (measured), which would dominate any at-rate
        feed.  Returns the number of packets accepted."""
        ants = np.ascontiguousarray(ants, np.int32)
        pols = np.ascontiguousarray(pols, np.int32)
        timestamps = np.ascontiguousarray(timestamps, np.uint64)
        n = len(ants)
        return self._lib.ingest_submit_burst(
            self._h,
            ants.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            pols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            timestamps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            payloads, samples_per_packet, n, fmt)

    # SPEAD application item IDs (MeerKAT convention for the timestamp;
    # the stream item carries ant * n_pols + pol)
    SPEAD_TS_ID = 0x1600
    SPEAD_STREAM_ID = 0x3101

    def submit_spead(self, datagram: bytes,
                     ts_id: int = SPEAD_TS_ID,
                     stream_id: int = SPEAD_STREAM_ID,
                     fmt: int = FORMAT_INT8) -> int:
        """Decode + place one SPEAD-64-48 datagram (the reference's
        spead2 wire format: 8-byte header, BE64 item pointers, payload;
        multi-packet heaps place via the 0x03 payload-offset item).
        Returns 0 ok, <0 on late/malformed (see csrc/ingest.cpp)."""
        return self._lib.ingest_submit_spead(
            self._h, datagram, len(datagram), ts_id, stream_id, fmt)

    def submit_spead_burst(self, datagrams, ts_id: int = SPEAD_TS_ID,
                           stream_id: int = SPEAD_STREAM_ID,
                           fmt: int = FORMAT_INT8) -> int:
        """One native call for a burst of SPEAD datagrams (the
        recvmmsg() shape).  ``datagrams`` is a list of datagram bytes,
        or a pre-packed ``(blob, lens)`` pair as produced by
        :func:`spead_packetize` (tx->rx loopback without re-framing).
        Returns the number placed."""
        if (isinstance(datagrams, tuple) and len(datagrams) == 2
                and isinstance(datagrams[0], (bytes, bytearray))
                and isinstance(datagrams[1], np.ndarray)
                and datagrams[1].dtype.kind in "iu"):
            # (blob, lens) pair — a 2-tuple of raw datagram BYTES (both
            # elements bytes, no ndarray) still takes the list path
            blob, lens = datagrams
            lens = np.ascontiguousarray(lens, np.uint64)
        else:
            lens = np.asarray([len(d) for d in datagrams], np.uint64)
            blob = b"".join(datagrams)
        return self._lib.ingest_submit_spead_burst(
            self._h, blob,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(lens), ts_id, stream_id, fmt)

    def retire(self, force: bool = False):
        """-> (chunk int8 (A,P,C) or None, fill_fraction)."""
        out = np.empty(self._shape, np.int8)
        r = self._lib.ingest_retire(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            1 if force else 0)
        if r == -5:
            raise RuntimeError("a retire_view() slot is still lent out "
                               "for this ring position; release() first")
        if r < 0:
            return None, 0.0
        return out, r / 1e6

    def retire_view(self, force: bool = False):
        """Zero-copy retire: -> (chunk VIEW int8 (A,P,C) or None, fill).

        The returned array aliases the assembler's own slot buffer (gap
        bytes zero-filled in place) — the production feed path hands
        this straight to the host->device transfer with no chunk-sized
        copy.  The slot stays out of the ring until :meth:`release`;
        only one view may be outstanding at a time."""
        ptr = ctypes.POINTER(ctypes.c_int8)()
        r = self._lib.ingest_retire_view(self._h, ctypes.byref(ptr),
                                         1 if force else 0)
        if r == -5:
            raise RuntimeError("retire_view already outstanding; "
                               "release() first")
        if r < 0:
            return None, 0.0
        arr = np.ctypeslib.as_array(ptr, shape=self._shape)
        return arr, r / 1e6

    def release(self) -> None:
        """Return the retire_view slot to the ring (the view's memory
        must no longer be read)."""
        self._lib.ingest_release(self._h)

    def tail_complete(self) -> bool:
        """True if the oldest chunk is fully covered and retirable —
        a peek, consuming nothing (multi-assembler consumers check all
        workers before retiring any)."""
        return bool(self._lib.ingest_tail_complete(self._h))

    def stats(self):
        ok = ctypes.c_uint64()
        late = ctypes.c_uint64()
        bad = ctypes.c_uint64()
        clipped = ctypes.c_uint64()
        self._lib.ingest_stats(self._h, ctypes.byref(ok),
                               ctypes.byref(late), ctypes.byref(bad),
                               ctypes.byref(clipped))
        return {"packets_ok": ok.value, "packets_late": late.value,
                "packets_bad": bad.value,
                # placed but lost a chunk segment to a borrowed-slot
                # wrap: consumer-too-slow data loss, invisible in
                # packets_ok/bad alone
                "packets_clipped": clipped.value}

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ingest_destroy(self._h)
                self._h = None
        except Exception:
            pass


class UdpSpeadReceiver:
    """The wire leg of the ingest tier: a native ``recvmmsg()`` thread
    pumping SPEAD datagrams off a real UDP socket into a
    :class:`NativeIngest` assembler (SURVEY.md §2.1 transport row, §3.2
    network boundary — the reference's equivalent is its spead2/UDP
    NIC-facing C++).  All datagram handling stays in C++
    (``csrc/ingest.cpp:udp_rx_create``); Python only starts/stops and
    reads counters.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    the localhost demo/tests use this).  The receiver holds a reference
    to the ingest so the assembler cannot be collected under the
    thread.
    """

    def __init__(self, ingest: NativeIngest, *, bind_addr: str = "0.0.0.0",
                 port: int = 0, ts_id: int = NativeIngest.SPEAD_TS_ID,
                 stream_id: int = NativeIngest.SPEAD_STREAM_ID,
                 fmt: int = NativeIngest.FORMAT_INT8,
                 rcvbuf_bytes: int = 8 * 1024 * 1024):
        self._lib = load_library()
        self._ingest = ingest          # keep the assembler alive
        self._h = ctypes.c_void_p(self._lib.udp_rx_create(
            ingest._h, bind_addr.encode(), port, ts_id, stream_id, fmt,
            rcvbuf_bytes))
        if not self._h:
            raise OSError(
                f"udp_rx_create failed for {bind_addr}:{port} "
                "(bad address or bind error)")
        self.port = self._lib.udp_rx_port(self._h)

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.udp_rx_stats(self._h, *map(ctypes.byref, vals))
        return {"datagrams": vals[0].value, "bytes": vals[1].value,
                "placed": vals[2].value, "rejected": vals[3].value}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.udp_rx_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UdpSpeadSink:
    """``sendmmsg()`` transmit sink for :class:`SpeadTransmitter`:
    ships a packetized burst (the exact ``(buf, lens)`` shape
    :func:`spead_packetize` produces) to ``addr:port`` with one syscall
    per 64 datagrams.  UDP semantics: a full socket buffer drops
    packets (counted in ``stats()["dropped"]``) rather than blocking
    the real-time path."""

    def __init__(self, addr: str, port: int,
                 sndbuf_bytes: int = 8 * 1024 * 1024):
        self._lib = load_library()
        self._h = ctypes.c_void_p(self._lib.udp_tx_create(
            addr.encode(), port, sndbuf_bytes))
        if not self._h:
            raise OSError(f"udp_tx_create failed for {addr}:{port}")

    def __call__(self, buf, lens) -> int:
        lens = np.ascontiguousarray(lens, np.uint64)
        return self._lib.udp_tx_send_burst(
            self._h, bytes(buf) if not isinstance(buf, bytes) else buf,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(lens))

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(3)]
        self._lib.udp_tx_stats(self._h, *map(ctypes.byref, vals))
        return {"datagrams": vals[0].value, "bytes": vals[1].value,
                "dropped": vals[2].value}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.udp_tx_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
