"""Native ingest library (csrc/ingest.cpp): packet reassembly, 10-bit
unpack, out-of-order & late-packet semantics — vs NumPy references."""

import os
import shutil

import numpy as np
import pytest

# the library builds with make+g++ on demand; a prebuilt .so also works
_SO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "libingest.so")
pytestmark = pytest.mark.skipif(
    not os.path.exists(_SO) and (shutil.which("make") is None
                                 or shutil.which("g++") is None),
    reason="no prebuilt libingest.so and no C++ toolchain")

from dc_sand_tpu.runtime.ingest import NativeIngest, unpack_10bit  # noqa: E402


def _spead_packet(items: dict, payload: bytes) -> bytes:
    """Reference SPEAD-64-48 packer: header + immediate BE64 item
    pointers + payload (matches csrc/ingest.cpp's decoder contract)."""
    out = bytearray()
    out += bytes([0x53, 0x04, 0x08, 0x06, 0x00, 0x00])
    out += len(items).to_bytes(2, "big")
    for item_id, val in items.items():
        ptr = (1 << 63) | (item_id << 48) | (val & ((1 << 48) - 1))
        out += ptr.to_bytes(8, "big")
    out += payload
    return bytes(out)


def _pack_10bit(samples10: np.ndarray) -> bytes:
    """NumPy reference packer: 4 samples -> 5 bytes, big-endian."""
    assert len(samples10) % 4 == 0
    out = bytearray()
    for g in range(len(samples10) // 4):
        bits = 0
        for i in range(4):
            bits = (bits << 10) | (int(samples10[g * 4 + i]) & 0x3FF)
        out += bits.to_bytes(5, "big")
    return bytes(out)


class TestUnpack10:
    def test_roundtrip_drops_lsbs(self):
        rng = np.random.default_rng(0)
        s10 = rng.integers(-512, 512, size=64)
        got = unpack_10bit(_pack_10bit(s10), 64)
        np.testing.assert_array_equal(got, (s10 >> 2).astype(np.int8))

    def test_extremes(self):
        s10 = np.array([511, -512, 0, -1])
        got = unpack_10bit(_pack_10bit(s10), 4)
        np.testing.assert_array_equal(got, [127, -128, 0, -1])


class TestAssembler:
    def test_in_order_assembly(self):
        a, p, c = 2, 2, 64
        ing = NativeIngest(a, p, c)
        rng = np.random.default_rng(1)
        ref = rng.integers(-100, 100, (a, p, c), dtype=np.int8)
        for i in range(a):
            for j in range(p):
                assert ing.submit(i, j, 0, ref[i, j].tobytes()) == 0
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk, ref)

    def test_out_of_order_and_split_packets(self):
        a, p, c = 1, 1, 128
        ing = NativeIngest(a, p, c)
        ref = np.arange(-64, 64, dtype=np.int8)
        # second half first, then first half; packet straddles nothing
        assert ing.submit(0, 0, 64, ref[64:].tobytes()) == 0
        assert ing.submit(0, 0, 0, ref[:64].tobytes()) == 0
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_packet_straddles_chunks(self):
        a, p, c = 1, 1, 32
        ing = NativeIngest(a, p, c, n_slots=4)
        payload = np.arange(48, dtype=np.int8)
        assert ing.submit(0, 0, 16, payload.tobytes()) == 0
        chunk0, fill0 = ing.retire(force=True)
        chunk1, fill1 = ing.retire(force=True)
        np.testing.assert_array_equal(chunk0[0, 0, 16:], payload[:16])
        np.testing.assert_array_equal(chunk0[0, 0, :16], 0)
        np.testing.assert_array_equal(chunk1[0, 0, :32], payload[16:])
        assert fill0 == 0.5 and fill1 == 1.0

    def test_late_packet_dropped_and_counted(self):
        ing = NativeIngest(1, 1, 32, n_slots=2)
        ing.submit(0, 0, 0, bytes(32))
        ing.retire()
        assert ing.submit(0, 0, 0, bytes(32)) == -1  # behind the window
        assert ing.stats()["packets_late"] == 1

    def test_too_far_future_rejected(self):
        ing = NativeIngest(1, 1, 32, n_slots=2)
        assert ing.submit(0, 0, 32 * 10, bytes(32)) == -3

    def test_incomplete_chunk_not_retired_without_force(self):
        """An early out-of-order packet must not flush the tail chunk:
        non-force retire waits for COMPLETE coverage (round-1 ADVICE)."""
        a, p, c = 1, 1, 64
        ing = NativeIngest(a, p, c)
        ref = np.arange(-32, 32, dtype=np.int8)
        assert ing.submit(0, 0, 32, ref[32:].tobytes()) == 0  # 2nd half only
        chunk, _ = ing.retire()                  # incomplete -> blocked
        assert chunk is None
        assert ing.submit(0, 0, 0, ref[:32].tobytes()) == 0   # rest arrives
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_duplicate_packets_do_not_overcount(self):
        """Overlapping/duplicate payloads are deduplicated in the fill
        accounting: fraction never exceeds 1.0 and completeness means
        distinct coverage, not byte-count."""
        a, p, c = 1, 1, 64
        ing = NativeIngest(a, p, c)
        ref = np.arange(-32, 32, dtype=np.int8)
        assert ing.submit(0, 0, 0, ref[:48].tobytes()) == 0
        assert ing.submit(0, 0, 16, ref[16:48].tobytes()) == 0  # duplicate
        chunk, _ = ing.retire()
        assert chunk is None                     # still missing [48:64)
        assert ing.submit(0, 0, 48, ref[48:].tobytes()) == 0
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_lost_chunk_retires_as_zeros(self):
        ing = NativeIngest(1, 1, 16, n_slots=2)
        none_chunk, _ = ing.retire()
        assert none_chunk is None
        chunk, fill = ing.retire(force=True)
        assert fill == 0.0
        np.testing.assert_array_equal(chunk, 0)

    def test_slot_reuse_zeroes_stale_gap_bytes(self):
        """The assembler no longer memsets slots eagerly — uncovered
        bytes are zeroed at retire via the coverage bitmap, so a partial
        chunk reusing a slot must NOT leak the previous occupant."""
        a, p, c = 1, 1, 64
        ing = NativeIngest(a, p, c, n_slots=2)
        full = np.full((c,), 55, np.int8)
        ing.submit(0, 0, 0, full.tobytes())
        chunk, fill = ing.retire()
        assert fill == 1.0
        ing.submit(0, 0, 1 * c, full.tobytes())
        ing.retire()
        # chunk 2 reuses chunk 0's slot; only cover bytes [16, 32)
        part = np.full((16,), 77, np.int8)
        ing.submit(0, 0, 2 * c + 16, part.tobytes())
        chunk, fill = ing.retire(force=True)
        ref = np.zeros((c,), np.int8)
        ref[16:32] = 77
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_retire_view_zero_copy_and_release(self):
        a, p, c = 2, 1, 64
        ing = NativeIngest(a, p, c, n_slots=2)
        rng = np.random.default_rng(5)
        ref = rng.integers(-100, 100, (a, p, c), dtype=np.int8)
        for i in range(a):
            ing.submit(i, 0, 0, ref[i, 0].tobytes())
        view, fill = ing.retire_view()
        assert fill == 1.0
        np.testing.assert_array_equal(view, ref)
        # a second outstanding view is refused
        with pytest.raises(RuntimeError, match="outstanding"):
            ing.retire_view(force=True)
        ing.release()
        chunk, _ = ing.retire(force=True)   # next chunk works post-release
        np.testing.assert_array_equal(chunk, 0)

    def test_borrowed_slot_wrap_drops_packets(self):
        """Packets that wrap onto a slot still lent out by retire_view
        are dropped and counted bad, never corrupting the view."""
        a, p, c = 1, 1, 16
        ing = NativeIngest(a, p, c, n_slots=2)
        ing.submit(0, 0, 0, np.full((c,), 9, np.int8).tobytes())
        view, _ = ing.retire_view()          # borrows chunk 0's slot
        bad0 = ing.stats()["packets_bad"]
        # chunk 2 maps to the borrowed slot (2 % 2 == 0)
        ing.submit(0, 0, 2 * c, np.full((c,), 1, np.int8).tobytes())
        assert ing.stats()["packets_bad"] == bad0 + 1
        np.testing.assert_array_equal(view[0, 0], 9)  # view intact
        ing.release()

    def test_borrowed_slot_straddle_counts_clipped(self):
        """A packet placed in one chunk but clipped in another (its
        segment wrapped onto a borrowed slot) counts packets_clipped —
        partial data loss must not hide behind packets_ok."""
        a, p, c = 1, 1, 16
        ing = NativeIngest(a, p, c, n_slots=2)
        ing.submit(0, 0, 0, np.full((c,), 9, np.int8).tobytes())
        view, _ = ing.retire_view()          # borrows chunk 0's slot
        # straddles chunks 1 and 2; chunk 2 maps to the borrowed slot
        ing.submit(0, 0, c + 8, np.full((c,), 5, np.int8).tobytes())
        st = ing.stats()
        assert st["packets_clipped"] == 1
        assert st["packets_ok"] == 2         # both placed (one partially)
        ing.release()
        chunk, _ = ing.retire(force=True)    # chunk 1: tail got its half
        ref = np.zeros((c,), np.int8)
        ref[8:] = 5
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_window_edge_straddle_counts_clipped(self):
        """Segments clipped at either ring-window edge are real data
        loss and must count packets_clipped, not hide in packets_ok."""
        a, p, c = 1, 1, 100
        ing = NativeIngest(a, p, c, n_slots=4)
        # straddles the window head: chunks [3, 4], window holds [0, 3]
        ing.submit(0, 0, 350, np.full((100,), 1, np.int8).tobytes())
        assert ing.stats()["packets_clipped"] == 1
        # advance the tail by one, then straddle it: chunks [0, 1]
        ing.retire(force=True)
        ing.submit(0, 0, 50, np.full((100,), 2, np.int8).tobytes())
        st = ing.stats()
        assert st["packets_clipped"] == 2
        assert st["packets_ok"] == 2           # both partially placed
        chunk, _ = ing.retire(force=True)      # chunk 1: got its half
        ref = np.zeros((c,), np.int8)
        ref[:50] = 2
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_tail_complete_ignores_non_tail_borrow(self):
        """A retire_view still held on the PREVIOUS chunk must not make
        a genuinely complete tail read incomplete (mirror of
        ingest_retire's borrowed-slot condition)."""
        a, p, c = 1, 1, 16
        ing = NativeIngest(a, p, c, n_slots=4)
        ing.submit(0, 0, 0, np.full((c,), 1, np.int8).tobytes())
        view, _ = ing.retire_view()            # borrow chunk 0's slot
        assert not ing.tail_complete()         # chunk 1 empty
        ing.submit(0, 0, c, np.full((c,), 2, np.int8).tobytes())
        assert ing.tail_complete()             # complete despite borrow
        ing.release()

    def test_bad_geometry_raises(self):
        for bad in ((4, 2, 0), (0, 2, 64), (4, 0, 64)):
            with pytest.raises(ValueError, match="geometry"):
                NativeIngest(*bad)
        with pytest.raises(ValueError, match="geometry"):
            NativeIngest(4, 2, 64, n_slots=0)

    def test_10bit_ragged_tail_rejected(self):
        ing = NativeIngest(1, 1, 64)
        # 7 bytes -> 5 samples: not a whole 4-sample group
        assert ing.submit(0, 0, 0, b"\x01" * 7,
                          fmt=NativeIngest.FORMAT_10BIT) == -2
        assert ing.stats()["packets_bad"] == 1

    def test_spead_stream_id_out_of_range(self):
        """Out-of-range (incl. 2^32-wrapping) stream ids are rejected
        before the int cast can alias them onto a valid antenna."""
        a, p, c = 4, 2, 32
        ing = NativeIngest(a, p, c)
        pay = np.full((c,), 3, np.int8).tobytes()
        for stream in (a * p,                      # one past the end
                       p * ((1 << 32) + 3)):       # wraps to ant 3
            d = _spead_packet({0x1600: 0, 0x3101: stream, 0x03: 0}, pay)
            assert ing.submit_spead(d) == -4
        st = ing.stats()
        assert st["packets_bad"] == 2 and st["packets_ok"] == 0
        chunk, fill = ing.retire(force=True)
        np.testing.assert_array_equal(chunk, 0)   # nothing aliased in

    def test_spead_10bit_group_alignment(self):
        """10-bit heaps split off a 5-byte group boundary are rejected
        (silent shifted-garbage decode otherwise); spead_packetize
        align=5 produces split points the decoder accepts."""
        from dc_sand_tpu.runtime.ingest import spead_packetize
        a, p, c = 1, 1, 64
        ing = NativeIngest(a, p, c)
        rng = np.random.default_rng(4)
        s10 = rng.integers(-512, 512, size=c)
        packed = _pack_10bit(s10)                  # 80 bytes
        # unaligned payload offset (8 % 5 != 0) and unaligned length
        bad_off = _spead_packet({0x1600: 0, 0x3101: 0, 0x03: 8},
                                packed[8:])
        assert ing.submit_spead(bad_off,
                                fmt=NativeIngest.FORMAT_10BIT) == -4
        bad_len = _spead_packet({0x1600: 0, 0x3101: 0, 0x03: 0},
                                packed[:12])
        assert ing.submit_spead(bad_len,
                                fmt=NativeIngest.FORMAT_10BIT) == -4
        # align=5 rounds max_payload 12 -> 10: 8 aligned datagrams
        buf, lens = spead_packetize(packed, 0, 0, max_payload=12,
                                    align=5)
        assert ing.submit_spead_burst(
            (buf, lens), fmt=NativeIngest.FORMAT_10BIT) == len(lens)
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0],
                                      (s10 >> 2).astype(np.int8))

    def test_multi_ingest_source_releases_on_error(self):
        """A failed retire (incomplete tail, force=False) must not leave
        earlier ingests' slots lent out — the next call, once data
        arrives, succeeds."""
        from dc_sand_tpu.runtime.ingest import multi_ingest_source
        a_w, p, c = 1, 1, 32
        ings = [NativeIngest(a_w, p, c) for _ in range(2)]
        full = np.full((c,), 7, np.int8).tobytes()
        ings[0].submit(0, 0, 0, full)              # complete
        ings[1].submit(0, 0, 0, full[: c // 2])    # half-filled
        src = multi_ingest_source(ings, force=False)
        with pytest.raises(RuntimeError, match="incomplete"):
            src(0)
        ings[1].submit(0, 0, c // 2, full[c // 2:])
        out = np.asarray(src(0))                   # no leaked slot
        np.testing.assert_array_equal(out, 7)

    def test_spead_datagram_roundtrip(self):
        """SPEAD-64-48 decode vs a NumPy reference packer: immediate
        timestamp/stream items route the payload exactly like a direct
        submit; multi-packet heaps place via the 0x03 payload offset."""
        a, p, c = 2, 2, 64
        ing = NativeIngest(a, p, c)
        rng = np.random.default_rng(9)
        ref = rng.integers(-100, 100, (a, p, c), dtype=np.int8)
        for ai in range(a):
            for pi in range(p):
                stream = ai * p + pi
                # two packets per heap: payload split at byte 40
                pay = ref[ai, pi].tobytes()
                d1 = _spead_packet({0x1600: 0, 0x3101: stream,
                                    0x03: 0}, pay[:40])
                d2 = _spead_packet({0x1600: 0, 0x3101: stream,
                                    0x03: 40}, pay[40:])
                assert ing.submit_spead(d1) == 0
                assert ing.submit_spead(d2) == 0
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk, ref)

    def test_spead_burst_and_malformed(self):
        a, p, c = 1, 1, 32
        ing = NativeIngest(a, p, c)
        pay = np.arange(c, dtype=np.int8).tobytes()
        good = _spead_packet({0x1600: 0, 0x3101: 0, 0x03: 0}, pay)
        bad_magic = b"\x00" + good[1:]
        no_stream = _spead_packet({0x1600: 0}, pay)
        assert ing.submit_spead_burst([good, bad_magic, no_stream]) == 1
        assert ing.stats()["packets_bad"] == 2
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0],
                                      np.arange(c, dtype=np.int8))

    def test_10bit_packets(self):
        a, p, c = 1, 1, 64
        ing = NativeIngest(a, p, c)
        rng = np.random.default_rng(2)
        s10 = rng.integers(-512, 512, size=c)
        ing.submit(0, 0, 0, _pack_10bit(s10), fmt=NativeIngest.FORMAT_10BIT)
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0],
                                      (s10 >> 2).astype(np.int8))

    def test_spead_roundtrip_fuzz(self):
        """Property fuzz over the full tx->rx wire path: any payload
        size, split size, arrival order, duplicate datagrams, and
        format must reassemble bit-exact with fill == 1.0."""
        from hypothesis import given, settings, strategies as st
        from dc_sand_tpu.runtime.ingest import spead_packetize

        @settings(max_examples=40, deadline=None)
        @given(st.data())
        def check(data):
            fmt = data.draw(st.sampled_from([NativeIngest.FORMAT_INT8,
                                             NativeIngest.FORMAT_10BIT]))
            # chunk sizes in 4-sample groups so 10-bit packing is legal
            c = 4 * data.draw(st.integers(2, 64))
            a = data.draw(st.integers(1, 3))
            p = data.draw(st.integers(1, 2))
            seed = data.draw(st.integers(0, 2**16))
            rng = np.random.default_rng(seed)
            ing = NativeIngest(a, p, c)
            if fmt == NativeIngest.FORMAT_10BIT:
                s10 = rng.integers(-512, 512, (a, p, c))
                ref = (s10 >> 2).astype(np.int8)
                payloads = [[_pack_10bit(s10[ai, pi])
                             for pi in range(p)] for ai in range(a)]
                align = 5
            else:
                ref = rng.integers(-100, 100, (a, p, c), dtype=np.int8)
                payloads = [[ref[ai, pi].tobytes()
                             for pi in range(p)] for ai in range(a)]
                align = 1
            mp = align * data.draw(st.integers(1, 8))
            grams = []
            for ai in range(a):
                for pi in range(p):
                    buf, lens = spead_packetize(
                        payloads[ai][pi], 0, ai * p + pi,
                        max_payload=mp, align=align)
                    off = 0
                    for ln in lens:
                        grams.append(bytes(buf[off:off + int(ln)]))
                        off += int(ln)
            # UDP semantics: shuffled order + some duplicates
            rng.shuffle(grams)
            grams += grams[: len(grams) // 3]
            for g in grams:
                assert ing.submit_spead(g, fmt=fmt) == 0
            chunk, fill = ing.retire()
            assert fill == 1.0
            np.testing.assert_array_equal(chunk, ref)

        check()

    def test_feeds_runner_source(self):
        """End-to-end: native chunks drive the FXRunner."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.windows import pfb_window
        cfg = ChainConfig(name="t", n_ants=2, n_pols=1, n_chans=32,
                          n_taps=4, spectra_per_chunk=4,
                          n_spectra_per_acc=4, run_xengine=True,
                          apply_requant=True)
        ing = NativeIngest(cfg.n_ants, cfg.n_pols, cfg.chunk_samples)
        rng = np.random.default_rng(3)
        n_chunks = 2
        data = rng.integers(-100, 100,
                            (cfg.n_ants, 1, n_chunks * cfg.chunk_samples),
                            dtype=np.int8)

        def source(i):
            for ant in range(cfg.n_ants):
                ing.submit(ant, 0, i * cfg.chunk_samples,
                           data[ant, 0, i * cfg.chunk_samples:
                                (i + 1) * cfg.chunk_samples].tobytes())
            chunk, fill = ing.retire(force=True)
            assert fill == 1.0
            return chunk

        runner = FXRunner(cfg, pfb_window(4, 64))
        dumps, counters = runner.run(source, n_chunks)
        assert counters.dumps == n_chunks
        assert np.any(dumps[0].vis != 0)

    def test_multi_ingest_source_matches_single(self):
        """Antenna-sharded assemblers (one per NIC queue) gathered by
        multi_ingest_source produce the same runner dumps as one
        assembler holding all antennas."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.runtime.ingest import multi_ingest_source
        from dc_sand_tpu.windows import pfb_window
        cfg = ChainConfig(name="t", n_ants=4, n_pols=1, n_chans=32,
                          n_taps=4, spectra_per_chunk=4,
                          n_spectra_per_acc=4, run_xengine=True,
                          apply_requant=True)
        rng = np.random.default_rng(6)
        n_chunks = 2
        c = cfg.chunk_samples
        data = rng.integers(-100, 100, (4, 1, n_chunks * c),
                            dtype=np.int8)
        # two workers x two antennas; feed everything up front (packets
        # for both chunks fit the 4-slot ring)
        workers = [NativeIngest(2, 1, c) for _ in range(2)]
        for w, ing in enumerate(workers):
            for ai in range(2):
                for i in range(n_chunks):
                    ing.submit(ai, 0, i * c,
                               data[2 * w + ai, 0,
                                    i * c:(i + 1) * c].tobytes())
        src = multi_ingest_source(workers)
        r1 = FXRunner(cfg, pfb_window(4, 64))
        dumps_m, _ = r1.run(src, n_chunks)

        def single(i):
            return data[:, :, i * c:(i + 1) * c]

        r2 = FXRunner(cfg, pfb_window(4, 64))
        dumps_s, _ = r2.run(single, n_chunks)
        for dm, ds in zip(dumps_m, dumps_s):
            np.testing.assert_array_equal(dm.vis, ds.vis)


class TestIngestDelay:
    def test_delay_matches_host_reference(self):
        """Ingest-applied coarse delay == the golden read-pointer model:
        aligned[t] = raw[t + max_delay - d]."""
        a, p, c, md = 2, 1, 64, 8
        ing = NativeIngest(a, p, c, n_slots=4)
        delays = [3, 8]
        for ai, d in enumerate(delays):
            ing.set_delay(ai, 0, d, md)
        rng = np.random.default_rng(60)
        raw = rng.integers(-100, 100, (a, 2 * c), dtype=np.int8)
        for ai in range(a):
            ing.submit(ai, 0, 0, raw[ai].tobytes())
        chunk, _ = ing.retire(force=True)
        # aligned[t] = raw[t - d], zeros for t < d (the same stream the
        # runner's host-delay path produces after its zero lead-in)
        for ai, d in enumerate(delays):
            np.testing.assert_array_equal(chunk[ai, 0, :d], 0)
            np.testing.assert_array_equal(chunk[ai, 0, d:],
                                          raw[ai, :c - d])

    def test_bad_delay_rejected(self):
        ing = NativeIngest(1, 1, 32)
        with pytest.raises(ValueError):
            ing.set_delay(0, 0, 40, 16)
        with pytest.raises(ValueError):
            ing.set_delay(5, 0, 1, 16)

    def test_delay_feeds_runner_like_host_path(self):
        """Runner with coarse_on_host=False + zero device delay, fed by
        ingest-delayed chunks, matches the host-delay runner path."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import DelayModel, FXRunner
        from dc_sand_tpu.windows import pfb_window
        cfg = ChainConfig(name="t", n_ants=2, n_pols=1, n_chans=32,
                          n_taps=4, spectra_per_chunk=4,
                          n_spectra_per_acc=8, run_xengine=True,
                          apply_delay=True, apply_requant=True)
        md = 8
        delays = np.array([[2], [7]])
        rng = np.random.default_rng(61)
        n_chunks = 2
        raw = rng.integers(-100, 100,
                           (2, 1, n_chunks * cfg.chunk_samples),
                           dtype=np.int8)

        # path A: runner's host-side coarse delay
        dm = DelayModel.zeros(2, 1, max_delay=md)
        dm.d0 = delays.astype(float)
        ra = FXRunner(cfg, pfb_window(4, 64), delay_model=dm)
        dumps_a, _ = ra.run(
            lambda i: raw[..., i * cfg.chunk_samples:
                          (i + 1) * cfg.chunk_samples], n_chunks)

        # path B: native ingest applies the same delay at placement;
        # runner sees a zero delay model
        ing = NativeIngest(2, 1, cfg.chunk_samples)
        for ai in range(2):
            ing.set_delay(ai, 0, int(delays[ai, 0]), md)

        def src(i):
            for ai in range(2):
                ing.submit(ai, 0, i * cfg.chunk_samples,
                           raw[ai, 0, i * cfg.chunk_samples:
                               (i + 1) * cfg.chunk_samples].tobytes())
            return ing.retire(force=True)[0]

        rb = FXRunner(cfg, pfb_window(4, 64),
                      delay_model=DelayModel.zeros(2, 1))
        dumps_b, _ = rb.run(src, n_chunks)
        np.testing.assert_array_equal(dumps_a[0].vis, dumps_b[0].vis)


class TestSpeadTransmit:
    """Native SPEAD-64-48 encoder (csrc/ingest.cpp:spead_encode) — the
    transmit mirror of the decode path; verified by tx->rx loopback."""

    def test_loopback_bitwise(self):
        """Packetize every (ant, pol) stream of a chunk, shuffle all
        datagrams (UDP reorders), feed them to an assembler: the retired
        chunk is bitwise the original."""
        from dc_sand_tpu.runtime import spead_packetize
        a, p, c = 2, 2, 300
        rng = np.random.default_rng(17)
        ref = rng.integers(-128, 128, (a, p, c), dtype=np.int8)
        frags = []
        for ai in range(a):
            for pi in range(p):
                buf, lens = spead_packetize(
                    ref[ai, pi], timestamp=0, stream=ai * p + pi,
                    heap_id=ai * p + pi, max_payload=128)
                off = 0
                for ln in lens:
                    frags.append(buf[off:off + int(ln)])
                    off += int(ln)
        assert len(frags) == a * p * 3          # ceil(300/128) per stream
        rng.shuffle(frags)
        ing = NativeIngest(a, p, c)
        assert ing.submit_spead_burst(frags) == len(frags)
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk, ref)

    def test_packed_burst_form(self):
        """(blob, lens) from the encoder feeds submit_spead_burst
        directly — the zero-reframing loopback path."""
        from dc_sand_tpu.runtime import spead_packetize
        c = 96
        ref = np.arange(c, dtype=np.int8) - 48
        ing = NativeIngest(1, 1, c)
        pair = spead_packetize(ref, timestamp=0, stream=0, max_payload=40)
        assert ing.submit_spead_burst(pair) == 3
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0], ref)

    def test_header_fields(self):
        """Emitted datagrams parse under the test's reference decoder
        rules: magic/version bytes, immediate item pointers, offsets."""
        from dc_sand_tpu.runtime import spead_packetize
        pay = bytes(range(250))
        buf, lens = spead_packetize(pay, timestamp=12345, stream=7,
                                    heap_id=99, max_payload=100)
        assert [int(x) for x in lens] == [156, 156, 106]
        off = 0
        for i, ln in enumerate(int(x) for x in lens):
            d = buf[off:off + ln]
            assert d[:4] == b"\x53\x04\x08\x06"
            n_items = int.from_bytes(d[6:8], "big")
            assert n_items == 6
            items = {}
            for j in range(n_items):
                ptr = int.from_bytes(d[8 + 8 * j:16 + 8 * j], "big")
                assert ptr >> 63 == 1                  # immediate
                items[(ptr >> 48) & 0x7FFF] = ptr & ((1 << 48) - 1)
            assert items[0x01] == 99                   # heap id
            assert items[0x02] == 250                  # heap length
            assert items[0x03] == i * 100              # payload offset
            assert items[0x1600] == 12345
            assert items[0x3101] == 7
            payload = d[8 + 8 * n_items:]
            assert items[0x04] == len(payload)
            assert payload == pay[i * 100:(i + 1) * 100]
            off += ln

    def test_transmitter_dump(self):
        """SpeadTransmitter ships a runner Dump as one heap (timestamp
        in sample ticks = first_chunk * ticks_per_chunk) and a loopback
        assembler reconstructs the visibility bytes exactly."""
        from dc_sand_tpu.runtime import SpeadTransmitter
        from dc_sand_tpu.runtime.runner import Dump
        rng = np.random.default_rng(3)
        vis = rng.integers(-2**31, 2**31, (6, 2, 2, 32, 2),
                           dtype=np.int32)
        nbytes = vis.nbytes
        dump = Dump(vis=vis, n_spectra=8, n_spectra_nominal=8,
                    first_chunk=4)
        # enough ring depth that the dump's true timeline position
        # (chunk 4) is inside the rx window
        rx = NativeIngest(1, 1, nbytes, n_slots=6)
        tx = SpeadTransmitter(
            lambda buf, lens: rx.submit_spead_burst((buf, lens)),
            max_payload=4096, ticks_per_chunk=nbytes)
        n_pkts = tx.send_dump(dump)
        assert n_pkts == -(-nbytes // 4096)
        assert tx.heaps_sent == 1
        for _ in range(4):                 # chunks 0-3: nothing sent
            _empty, fill = rx.retire(force=True)
            assert fill == 0.0
        got, fill = rx.retire(force=True)  # chunk 4: the dump heap
        assert fill == 1.0
        assert np.asarray(got).tobytes() == vis.tobytes()

    def test_burst_two_datagram_tuple(self):
        """A 2-tuple of raw datagram BYTES is a burst of two packets,
        not a (blob, lens) pair."""
        from dc_sand_tpu.runtime import spead_packetize
        c = 64
        ref = np.arange(c, dtype=np.int8)
        buf, lens = spead_packetize(ref, timestamp=0, stream=0,
                                    max_payload=32)
        assert len(lens) == 2
        d1, d2 = buf[:int(lens[0])], buf[int(lens[0]):]
        ing = NativeIngest(1, 1, c)
        assert ing.submit_spead_burst((d1, d2)) == 2
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk[0, 0], ref)


class TestUdpTransport:
    """The REAL wire leg (csrc/ingest.cpp UDP tier): SpeadTransmitter ->
    sendmmsg socket -> localhost UDP -> recvmmsg receiver thread ->
    NativeIngest, with loss counters live end to end."""

    def _wait(self, cond, timeout=5.0):
        import time
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if cond():
                return True
            time.sleep(0.01)
        return cond()

    def test_udp_end_to_end_bitwise(self):
        """Every (ant, pol) stream of a chunk crosses an actual UDP
        socket and reassembles bitwise."""
        from dc_sand_tpu.runtime.ingest import (NativeIngest,
                                                SpeadTransmitter,
                                                UdpSpeadReceiver,
                                                UdpSpeadSink)
        a, p, c = 2, 2, 4096
        rng = np.random.default_rng(23)
        ref = rng.integers(-128, 128, (a, p, c), dtype=np.int8)
        ing = NativeIngest(a, p, c)
        with UdpSpeadReceiver(ing, bind_addr="127.0.0.1") as rx:
            assert rx.port > 0
            with UdpSpeadSink("127.0.0.1", rx.port) as sink:
                tx = SpeadTransmitter(sink, max_payload=1024)
                n_sent = 0
                for ai in range(a):
                    for pi in range(p):
                        n_sent += tx.send(ref[ai, pi], timestamp=0,
                                          stream=ai * p + pi)
                assert sink.stats()["datagrams"] == n_sent
                assert sink.stats()["dropped"] == 0
                ok = self._wait(
                    lambda: rx.stats()["placed"] >= n_sent)
                st = rx.stats()
                assert ok, f"receiver placed {st['placed']}/{n_sent}"
                assert st["datagrams"] == n_sent
                assert st["rejected"] == 0
        chunk, fill = ing.retire()
        assert fill == 1.0
        np.testing.assert_array_equal(chunk, ref)

    def test_udp_receiver_rejects_garbage(self):
        """A non-SPEAD datagram bumps the rejected counter (and the
        assembler's packets_bad), never crashes the thread."""
        import socket
        from dc_sand_tpu.runtime.ingest import (NativeIngest,
                                                UdpSpeadReceiver)
        ing = NativeIngest(1, 1, 64)
        with UdpSpeadReceiver(ing, bind_addr="127.0.0.1") as rx:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(b"not spead at all", ("127.0.0.1", rx.port))
            s.close()
            assert self._wait(lambda: rx.stats()["rejected"] >= 1)
            assert rx.stats()["datagrams"] >= 1
        assert ing.stats()["packets_bad"] >= 1

    def test_udp_receiver_bad_bind_raises(self):
        from dc_sand_tpu.runtime.ingest import (NativeIngest,
                                                UdpSpeadReceiver)
        ing = NativeIngest(1, 1, 64)
        with pytest.raises(OSError):
            UdpSpeadReceiver(ing, bind_addr="not-an-address")

    def test_udp_sink_bad_addr_raises(self):
        from dc_sand_tpu.runtime.ingest import UdpSpeadSink
        with pytest.raises(OSError):
            UdpSpeadSink("999.999.0.1", 1)

    def test_udp_dump_products_cross_the_wire(self):
        """The outward product path (visibility dump -> SPEAD -> UDP ->
        downstream consumer) round-trips through a real socket."""
        from dc_sand_tpu.runtime.ingest import (NativeIngest,
                                                SpeadTransmitter,
                                                UdpSpeadReceiver,
                                                UdpSpeadSink)
        rng = np.random.default_rng(5)
        vis = rng.integers(-2**31, 2**31, (10, 2, 2, 16, 2),
                           dtype=np.int32)
        nbytes = vis.nbytes
        rx_ing = NativeIngest(1, 1, nbytes)
        with UdpSpeadReceiver(rx_ing, bind_addr="127.0.0.1") as rx:
            with UdpSpeadSink("127.0.0.1", rx.port) as sink:
                tx = SpeadTransmitter(sink, max_payload=2048)
                n = tx.send(np.ascontiguousarray(vis).view(np.int8),
                            timestamp=0, stream=0)
                assert self._wait(lambda: rx.stats()["placed"] >= n)
        got, fill = rx_ing.retire()
        assert fill == 1.0
        assert np.asarray(got).tobytes() == vis.tobytes()


class TestE2EAtRate:
    def test_harness_verifies_dumps(self):
        """The at-rate rehearsal harness (SPEAD -> NativeIngest -> h2d
        -> FXRunner, feeder thread overlapping device compute) produces
        golden-verified dumps and clean loss counters at a CI shape —
        the same code path the on-chip e2e record runs at contract
        scale."""
        from dc_sand_tpu.bench.ingest_bench import bench_e2e_atrate
        r = bench_e2e_atrate(n_ants=4, n_pols=2, n_chans=256,
                             spectra=32, n_chunks=4,
                             packet_samples=4096)
        assert r.extra["dumps_verified"] is True
        assert len(r.extra["dump_snrs_db"]) == 2
        assert all(s > 50 for s in r.extra["dump_snrs_db"])
        st = r.extra["ingest_stats"]
        assert st["packets_late"] == 0 and st["packets_bad"] == 0
        assert r.value > 0
