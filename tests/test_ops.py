"""Kernel-unit level (SURVEY.md §4.2): every op vs its float64 golden
model at >50 dB SNR, on the CPU backend."""

import numpy as np
import pytest
import jax.numpy as jnp

from dc_sand_tpu import golden, ops
from dc_sand_tpu.models import f_engine as jx_f_engine
from dc_sand_tpu.models.fengine import coarse_delay
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu.utils import snr_db, np_c2ri, np_ri2c

SNR_BOUND = 50.0  # BASELINE.json:5

N_CHANS = 128
M = 2 * N_CHANS
TAPS = 4


def _noise_int8(shape, seed=0, sigma=20.0):
    return golden.quantize_adc(golden.gaussian_noise(shape, sigma, seed))


class TestPFBFir:
    def test_matches_golden(self):
        x = _noise_int8((2, (32 + TAPS - 1) * M), seed=1)
        w = pfb_window(TAPS, M)
        ref = golden.pfb_fir(x, w, TAPS, M)
        out = ops.pfb_fir(jnp.asarray(x), w, TAPS, M)
        assert out.shape == ref.shape
        assert snr_db(ref, np.asarray(out)) > 120  # int8-exact in fp32

    def test_float_input(self):
        x = golden.gaussian_noise((8 + TAPS - 1) * M, seed=4).astype(np.float32)
        w = pfb_window(TAPS, M)
        ref = golden.pfb_fir(x, w, TAPS, M)
        out = ops.pfb_fir(jnp.asarray(x), w, TAPS, M)
        assert snr_db(ref, np.asarray(out)) > 120


class TestChannelize:
    def test_matches_golden(self):
        x = _noise_int8((4 + TAPS - 1) * M, seed=5)
        w = pfb_window(TAPS, M)
        fir = golden.pfb_fir(x, w, TAPS, M)
        ref = golden.channelize(fir, N_CHANS)
        out = ops.channelize(jnp.asarray(fir, jnp.float32), N_CHANS)
        assert snr_db(ref, np.asarray(out)) > 100

    @pytest.mark.parametrize("n_chans", [64, 1024])
    def test_mxu_matmul_fft_matches_rfft(self, n_chans):
        """The matmul-formulated rfft (ops/fft_mxu.py, benched via
        `cli bench fft`) matches numpy float64 rfft in natural bin
        order at contract precision."""
        from dc_sand_tpu.ops.fft_mxu import channelize_mxu
        rng = np.random.default_rng(9)
        x = rng.normal(size=(3, 4, 2 * n_chans)).astype(np.float32) * 30
        ref = np.fft.rfft(x.astype(np.float64))[..., :n_chans]
        out = np.asarray(channelize_mxu(jnp.asarray(x), n_chans))
        assert out.shape == ref.shape
        assert snr_db(ref, out) > 100

    def test_mxu_fft_rejects_bad_length(self):
        from dc_sand_tpu.ops.fft_mxu import channelize_mxu
        with pytest.raises(ValueError, match="FFT length"):
            channelize_mxu(jnp.zeros((2, 100), jnp.float32), 64)


class TestPhase:
    def test_matches_golden(self):
        rng = np.random.default_rng(6)
        s = (rng.normal(size=(2, 5, N_CHANS)) +
             1j * rng.normal(size=(2, 5, N_CHANS)))
        fd = rng.uniform(-0.5, 0.5, size=(2, 5))
        ph = rng.uniform(-np.pi, np.pi, size=(2, 5))
        ref = golden.fine_delay_fringe(s, fd, ph)
        out = ops.fine_delay_fringe(jnp.asarray(s, jnp.complex64),
                                    jnp.asarray(fd), jnp.asarray(ph))
        assert snr_db(ref, np.asarray(out)) > 100


class TestRequant:
    def test_matches_golden(self):
        rng = np.random.default_rng(7)
        s = 60 * (rng.normal(size=(3, 4, N_CHANS)) +
                  1j * rng.normal(size=(3, 4, N_CHANS)))
        g = rng.uniform(0.5, 2.0, size=N_CHANS) * np.exp(
            1j * rng.uniform(-np.pi, np.pi, size=N_CHANS))
        ref = golden.requantize(s, g)
        q = ops.requantize(jnp.asarray(s, jnp.complex64),
                           jnp.asarray(g, jnp.complex64))
        assert q.dtype == jnp.int8
        out = np.asarray(ops.dequantize(q))
        # rounding boundaries may differ by 1 LSB in fp32 vs fp64 on a
        # measure-zero set; require SNR not bit-exactness
        assert snr_db(ref, out) > 55

    def test_dequant_roundtrip(self):
        q = jnp.asarray(np.array([[3, -4], [127, -127]], np.int8))
        np.testing.assert_array_equal(np.asarray(ops.dequantize(q)),
                                      [3 - 4j, 127 - 127j])


class TestCoarseDelay:
    def test_matches_golden(self):
        x = _noise_int8((2, 2, 200), seed=8)
        d = np.array([[0, 5], [11, 16]])
        ref = golden.apply_coarse_delay(x, d, 16)
        out = coarse_delay(jnp.asarray(x), jnp.asarray(d), 16)
        np.testing.assert_array_equal(ref, np.asarray(out))


class TestXcorr:
    def test_matches_golden(self):
        n_ants, n_pols, nb = 4, 2, 10
        rng = np.random.default_rng(9)
        q_int = rng.integers(-100, 100, size=(n_ants, n_pols, nb, N_CHANS, 2))
        x_cplx = q_int[..., 0] + 1j * q_int[..., 1]
        ref = golden.xcorr(x_cplx)
        q = jnp.asarray(np.moveaxis(q_int, 3, 0), jnp.int8)  # channel-major
        v = np.asarray(ops.xcorr(q))  # (bl, pi, pj, k, 2) int32
        out = v[..., 0] + 1j * v[..., 1]
        np.testing.assert_array_equal(ref, out)  # int math: exact

    def test_accumulation_across_chunks_adds(self):
        rng = np.random.default_rng(10)
        q_int = rng.integers(-50, 50, size=(2, 1, 8, 16, 2))
        q = jnp.asarray(np.moveaxis(q_int, 3, 0), jnp.int8)
        v_all = np.asarray(ops.xcorr(q))
        v_sum = np.asarray(ops.xcorr(q[:, :, :, :4])) + \
            np.asarray(ops.xcorr(q[:, :, :, 4:]))
        np.testing.assert_array_equal(v_all, v_sum)


class TestBeamform:
    def test_matches_golden_complex_input(self):
        rng = np.random.default_rng(11)
        x = (rng.normal(size=(4, 2, 3, N_CHANS)) +
             1j * rng.normal(size=(4, 2, 3, N_CHANS)))
        w = (rng.normal(size=(3, 4, N_CHANS)) +
             1j * rng.normal(size=(3, 4, N_CHANS)))
        ref = golden.beamform(x, w)
        out = ops.beamform(jnp.asarray(np_c2ri(x)), jnp.asarray(np_c2ri(w)))
        assert snr_db(ref, np_ri2c(out)) > 100

    def test_int8_input_path(self):
        rng = np.random.default_rng(12)
        q_int = rng.integers(-100, 100, size=(4, 2, 3, 32, 2))
        w = (rng.normal(size=(2, 4, 32)) + 1j * rng.normal(size=(2, 4, 32)))
        ref = golden.beamform(q_int[..., 0] + 1j * q_int[..., 1], w)
        out = ops.beamform(jnp.asarray(q_int, jnp.int8), jnp.asarray(np_c2ri(w)))
        assert snr_db(ref, np_ri2c(out)) > 100

    def test_incoherent_matches_golden(self):
        rng = np.random.default_rng(13)
        q_int = rng.integers(-100, 100, size=(5, 2, 3, 16, 2))
        ref = golden.incoherent_sum(q_int[..., 0] + 1j * q_int[..., 1])
        out = ops.incoherent_sum(jnp.asarray(q_int, jnp.int8))
        np.testing.assert_allclose(ref, np.asarray(out), rtol=1e-6)


class TestFEngineEndToEnd:
    """Config-1 semantics (BASELINE.json:7): full chain vs golden > 50 dB."""

    def test_bare_pfb_cw_tone(self):
        fs = 1712e6
        k0 = 33
        n = (8 + TAPS - 1) * M
        x = golden.quantize_adc(golden.cw_tone(n, k0 * fs / M, fs, 90.0))
        w = pfb_window(TAPS, M, "hann")
        ref = golden.channelize(golden.pfb_fir(x, w, TAPS, M), N_CHANS)
        out = jx_f_engine(jnp.asarray(x), w, TAPS, N_CHANS)
        assert snr_db(ref, np_ri2c(out)) > SNR_BOUND

    def test_full_chain_with_all_stages(self):
        rng = np.random.default_rng(14)
        n = (6 + TAPS - 1) * M + 32
        x = _noise_int8((2, 2, n), seed=15)
        d = np.array([[0, 7], [13, 32]])
        fd = rng.uniform(-0.5, 0.5, size=(2, 2, 6))
        ph = rng.uniform(-np.pi, np.pi, size=(2, 2, 6))
        g = np.full(N_CHANS, 0.05) * np.exp(
            1j * rng.uniform(-np.pi, np.pi, size=N_CHANS))
        w = pfb_window(TAPS, M)
        ref = golden.f_engine(x, w, TAPS, N_CHANS, coarse_delays=d,
                              max_delay=32, frac_delay=fd, phase=ph, gains=g)
        out = jx_f_engine(jnp.asarray(x), w, TAPS, N_CHANS,
                          coarse_delays=jnp.asarray(d), max_delay=32,
                          frac_delay=jnp.asarray(fd), phase=jnp.asarray(ph),
                          gains=jnp.asarray(np_c2ri(g)))
        assert snr_db(ref, np.asarray(ops.dequantize(out))) > SNR_BOUND


class TestFEngineContractShapes:
    """The plain F-engine (``models.f_engine``: FIR -> rfft -> phase ->
    requant, left to XLA) vs the float64 golden chain at the contract's
    channel counts (SURVEY.md §4.2 kernel-unit)."""

    def _data(self, taps, nch, B, seed=20):
        m = 2 * nch
        rng = np.random.default_rng(seed)
        x = _noise_int8((2, (B + taps - 1) * m), seed=seed)
        w = pfb_window(taps, m)
        fd = rng.uniform(-0.5, 0.5, (2, B))
        ph = rng.uniform(-np.pi, np.pi, (2, B))
        g = np.full(nch, 0.05) * np.exp(
            1j * rng.uniform(-np.pi, np.pi, nch))
        return m, x, w, fd, ph, g

    def _quantized(self, x, w, taps, nch, fd, ph, g, **kw):
        return jx_f_engine(jnp.asarray(x), w, taps, nch,
                           frac_delay=jnp.asarray(fd),
                           phase=jnp.asarray(ph),
                           gains=jnp.asarray(np_c2ri(g)), **kw)

    def test_quantized_matches_golden(self):
        taps, nch, B = 4, 512, 16
        m, x, w, fd, ph, g = self._data(taps, nch, B)
        ref = golden.f_engine(x, w, taps, nch, frac_delay=fd, phase=ph,
                              gains=g)
        out = self._quantized(x, w, taps, nch, fd, ph, g)
        # fp32-vs-fp64 rounding flips at requant half-way boundaries cost
        # a few dB on small integers; contract bound is 50 (BASELINE.json:5)
        assert snr_db(ref, np_ri2c(out)) > 65

    @pytest.mark.parametrize("nch", [1024, 2048, 4096])
    def test_contract_channel_counts_match_golden(self, nch):
        """The FFT length grows to 8192 at the contract shapes — the
        rfft and the requant boundaries at those lengths must be
        CI-verified, not only card-verified."""
        taps, B = 4, 16
        m, x, w, fd, ph, g = self._data(taps, nch, B, seed=22)
        ref = golden.f_engine(x, w, taps, nch, frac_delay=fd, phase=ph,
                              gains=g)
        out = self._quantized(x, w, taps, nch, fd, ph, g)
        assert snr_db(ref, np_ri2c(out)) > 65

    def test_bare_matches_golden(self):
        taps, nch, B = 16, 512, 16
        m, x, w, _, _, _ = self._data(taps, nch, B)
        ref = golden.f_engine(x, w, taps, nch)
        out = jx_f_engine(jnp.asarray(x), w, taps, nch)
        assert snr_db(ref, np_ri2c(out)) > 100

    def test_unknown_layout_rejected(self):
        with pytest.raises(ValueError, match="unknown layout"):
            jx_f_engine(jnp.zeros((1, 8 * M), jnp.int8), pfb_window(TAPS, M),
                        TAPS, N_CHANS, layout="native")

    def test_wire_flat_bytes_equal_wire_at_contract_shape(self):
        """The flat (B, 2K) contract: byte-identical to the shipped
        shaped wire (B, K, 2) form, at a contract channel count (4096).
        wire_flat is a bench/API surface (the pipeline ships the shaped
        form); this pins the documented byte contract end-to-end."""
        taps, nch, B = 4, 4096, 16
        m, x, w, fd, ph, g = self._data(taps, nch, B, seed=24)
        shaped = np.asarray(self._quantized(x, w, taps, nch, fd, ph, g,
                                            layout="wire"))
        flat = np.asarray(self._quantized(x, w, taps, nch, fd, ph, g,
                                          layout="wire_flat"))
        assert flat.shape == shaped.shape[:-2] + (2 * nch,)
        np.testing.assert_array_equal(
            shaped.reshape(flat.shape), flat)


class TestXcorrAccumulate:
    """Streaming block accumulator + dump-time extraction (C8/C9) vs the
    per-chunk golden xcorr."""

    def _chunks(self, k=8, n_ants=8, n_pols=2, b=128, n_chunks=3, seed=33):
        rng = np.random.default_rng(seed)
        return [rng.integers(-100, 100, (k, n_ants, n_pols, b, 2),
                             dtype=np.int8) for _ in range(n_chunks)]

    def _golden_total(self, chunks):
        tot = None
        for q in chunks:
            # golden.xcorr wants (ant, pol, b, k) complex
            qc = (q[..., 0] + 1j * q[..., 1]).transpose(1, 2, 3, 0)
            v = golden.xcorr(qc)
            tot = v if tot is None else tot + v
        return tot

    def _run(self, chunks=None):
        if chunks is None:
            chunks = self._chunks()
        k, a, p = chunks[0].shape[:3]
        acc = jnp.zeros(ops.acc_shape(a, p, k), jnp.int32)
        for q in chunks:
            acc = ops.xcorr_accumulate(acc, jnp.asarray(q))
        return np.asarray(ops.extract_vis(acc, a, p)), chunks

    def test_jnp_matches_golden_exact(self):
        vis, chunks = self._run()
        ref = self._golden_total(chunks)
        np.testing.assert_array_equal(vis[..., 0], ref.real)
        np.testing.assert_array_equal(vis[..., 1], ref.imag)

    def test_matches_per_chunk_xcorr(self):
        """The dump-cadence path == summing per-chunk extracted xcorr."""
        chunks = self._chunks(n_chunks=2)
        vis, _ = self._run(chunks)
        per_chunk = sum(np.asarray(ops.xcorr(jnp.asarray(q)))
                        for q in chunks)
        np.testing.assert_array_equal(vis, per_chunk)

class TestXcorrExactAtContractShapes:
    """The X-engine's s8 x s8 -> s32 CMAC integrates EXACTLY: the packed
    accumulator, extracted at dump time, equals the golden visibilities
    bit for bit at 4 and 64 dual-pol antennas and 128/512-spectra
    chunks (the shapes the removed kernel tests covered)."""

    @pytest.mark.parametrize("ap", [8, 128])
    @pytest.mark.parametrize("b", [128, 512])
    def test_accumulate_equals_golden(self, ap, b):
        n_ants, k = ap // 2, 4
        rng = np.random.default_rng(ap + b)
        chunks = [rng.integers(-127, 128, (k, n_ants, 2, b, 2),
                               dtype=np.int8) for _ in range(2)]
        acc = jnp.zeros(ops.acc_shape(n_ants, 2, k), jnp.int32)
        for q in chunks:
            acc = ops.xcorr_accumulate(acc, jnp.asarray(q))
        vis = np.asarray(ops.extract_vis(acc, n_ants, 2))
        qc = np.concatenate(chunks, axis=3)
        ref = golden.xcorr((qc[..., 0] + 1j * qc[..., 1])
                           .transpose(1, 2, 3, 0))
        np.testing.assert_array_equal(vis[..., 0], ref.real)
        np.testing.assert_array_equal(vis[..., 1], ref.imag)

    def test_step_reset_starts_a_new_window(self):
        """``make_step``'s reset flag zeroes the carried accumulator at a
        dump boundary: the step after a reset holds exactly that chunk's
        visibilities, the step without one keeps integrating."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.models.pipeline import (history_len, make_step,
                                                 zero_vis_acc)
        cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=8,
                          n_spectra_per_acc=8, apply_requant=True,
                          run_xengine=True)
        step = make_step(cfg, pfb_window(TAPS, M), donate=False)
        rng = np.random.default_rng(77)
        chunks = [jnp.asarray(_noise_int8((4, 2, cfg.chunk_samples),
                                          seed=s)) for s in (1, 2)]
        gains = np.zeros((N_CHANS, 2), np.float32)
        gains[:, 0] = 0.05
        rest = (jnp.zeros((4, 2), jnp.int32),
                jnp.asarray(rng.uniform(-0.5, 0.5, (4, 2, 8)), jnp.float32),
                jnp.zeros((4, 2, 8), jnp.float32), jnp.asarray(gains),
                jnp.zeros((1, 4, N_CHANS, 2), jnp.float32))
        hist = jnp.zeros((4, 2, history_len(cfg, 0)), jnp.int8)
        h1, acc1, _ = step(hist, zero_vis_acc(cfg), chunks[0], *rest,
                           jnp.asarray(True))
        _, kept, _ = step(h1, acc1, chunks[1], *rest, jnp.asarray(False))
        _, fresh, _ = step(h1, acc1, chunks[1], *rest, jnp.asarray(True))
        _, alone, _ = step(h1, zero_vis_acc(cfg), chunks[1], *rest,
                           jnp.asarray(False))
        assert np.any(np.asarray(acc1))
        np.testing.assert_array_equal(np.asarray(fresh), np.asarray(alone))
        np.testing.assert_array_equal(
            np.asarray(kept), np.asarray(acc1) + np.asarray(alone))


class TestBeamformInt8AtContractShapes:
    """The HIGHEST-precision float32 beamformer on int8 spectra vs the
    float64 golden, at 64 dual-pol antennas and 16 beams."""

    @pytest.mark.parametrize("b", [128, 512])
    def test_int8_beams_match_golden(self, b):
        rng = np.random.default_rng(b)
        a, p, k, nb = 64, 2, 8, 16
        q = rng.integers(-127, 128, (a, p, b, k, 2), dtype=np.int8)
        w = rng.normal(size=(nb, a, k, 2)).astype(np.float32)
        ref = golden.beamform(q[..., 0] + 1j * q[..., 1],
                              w[..., 0] + 1j * w[..., 1])
        out = ops.beamform(jnp.asarray(q), jnp.asarray(w))
        assert out.shape == (nb, p, b, k, 2)
        assert snr_db(ref, np_ri2c(out)) > 100

    def test_incoherent_sum_at_128_antpols(self):
        rng = np.random.default_rng(128)
        q = rng.integers(-127, 128, (64, 2, 128, 8, 2), dtype=np.int8)
        ref = golden.incoherent_sum(q[..., 0] + 1j * q[..., 1])
        out = np.asarray(ops.incoherent_sum(jnp.asarray(q)))
        # integer-valued sums below 2^24: exact in float32 (the golden's
        # float64 |x|^2 carries ~1e-16 relative rounding)
        np.testing.assert_allclose(ref, np.rint(ref), rtol=1e-12)
        np.testing.assert_array_equal(out, np.rint(ref))


class TestStokes:
    def test_matches_golden(self):
        rng = np.random.default_rng(31)
        b_ri = rng.normal(size=(3, 2, 4, 16, 2)).astype(np.float32)
        b_c = b_ri[..., 0] + 1j * b_ri[..., 1]
        ref = golden.stokes(b_c)
        out = ops.stokes(jnp.asarray(b_ri))
        assert out.shape == (3, 4, 4, 16)
        assert snr_db(ref, np.asarray(out)) > 100

    def test_pure_x_pol(self):
        b = np.zeros((1, 2, 1, 4, 2), np.float32)
        b[0, 0, 0, :, 0] = 3.0  # x = 3+0j, y = 0
        s = np.asarray(ops.stokes(jnp.asarray(b)))
        np.testing.assert_allclose(s[0, 0, 0], 9.0)   # I
        np.testing.assert_allclose(s[0, 1, 0], 9.0)   # Q
        np.testing.assert_allclose(s[0, 2:, 0], 0.0)  # U, V

    def test_single_pol_rejected(self):
        with pytest.raises(ValueError):
            ops.stokes(jnp.zeros((1, 1, 2, 4, 2)))


class TestFuzzFEngine:
    def test_shapes_fuzz_vs_golden(self):
        """Property fuzz over (taps, chans, ants, pols, chunks, stage
        toggles): the jnp F-engine path must track the float64 golden
        chain above the contract bound at ANY shape combination, not
        just the pinned test shapes."""
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=15, deadline=None)
        @given(st.data())
        def check(data):
            taps = data.draw(st.sampled_from([2, 3, 4, 8, 16]))
            nch = data.draw(st.sampled_from([16, 32, 64, 128]))
            a = data.draw(st.integers(1, 3))
            p = data.draw(st.integers(1, 2))
            nb = data.draw(st.integers(1, 6))
            with_delay = data.draw(st.booleans())
            with_gains = data.draw(st.booleans())
            seed = data.draw(st.integers(0, 2**16))
            m = 2 * nch
            rng = np.random.default_rng(seed)
            x = _noise_int8((a, p, (nb + taps - 1) * m), seed=seed)
            w = pfb_window(taps, m)
            kw_g, kw_j = {}, {}
            if with_delay:
                fd = rng.uniform(-0.5, 0.5, (a, p, nb))
                ph = rng.uniform(-np.pi, np.pi, (a, p, nb))
                kw_g = {"frac_delay": fd, "phase": ph}
                kw_j = {"frac_delay": jnp.asarray(fd, jnp.float32),
                        "phase": jnp.asarray(ph, jnp.float32)}
            if with_gains:
                g = np.full(nch, 0.05) * np.exp(
                    1j * rng.uniform(-np.pi, np.pi, nch))
                kw_g["gains"] = g
                kw_j["gains"] = jnp.asarray(np_c2ri(g))
            ref = golden.f_engine(x, w, taps, nch, **kw_g)
            out = jx_f_engine(jnp.asarray(x), w, taps, nch,
                              **kw_j)
            outc = np_ri2c(out)
            snr = snr_db(ref, outc)
            if not with_gains:
                assert snr > 100, (taps, nch, a, p, nb, with_delay, snr)
                return
            # With requant the comparison is int8 vs int8, and the fp32
            # fine-delay phasor differs from the fp64 golden by ~1e-6
            # absolute at |v|~10 — a value that lands within that of a
            # round-half-even boundary legitimately flips one LSB either
            # way.  At fuzz sizes (512 samples) a single flip alone is
            # ~51 dB, so a bare SNR bound >50 would be flaky by
            # construction.  Certify instead that EVERY diff is a
            # single-LSB flip whose golden *pre-round* component sits
            # within 1e-3 of a .5 boundary (a wrong rounding mode, gain,
            # or phase produces diffs far from boundaries / >1 LSB), and
            # keep the >50 dB contract bound (BASELINE.json:5).
            assert snr > 50, (taps, nch, a, p, nb, with_delay, snr)
            d = outc - ref
            flips = np.argwhere(np.abs(d) > 0)
            if flips.size:
                kw_pre = dict(kw_g)
                g = kw_pre.pop("gains")
                pre = golden.f_engine(x, w, taps, nch, **kw_pre) * g
                assert np.abs(d.real).max() <= 1 and \
                    np.abs(d.imag).max() <= 1, (taps, nch, seed, snr)
                for i in map(tuple, flips):
                    for comp, dd in ((pre[i].real, d[i].real),
                                     (pre[i].imag, d[i].imag)):
                        if dd:
                            frac = abs(comp - np.floor(comp) - 0.5)
                            assert frac < 1e-3, (i, comp, snr)

        check()

    def test_boundary_flip_regression(self):
        """Round-3 red case pinned: taps=2 nch=128 nb=4 seed=38282 with
        delay+gains produced exactly one 1-LSB flip (golden pre-round
        imag 7.5000011, i.e. 1.1e-6 from the .5 boundary) -> 50.78 dB.
        The flip is irreducible fp32-phasor-vs-fp64 boundary ambiguity;
        certify the flip-site property and the 50 dB contract bound."""
        taps, nch, a, p, nb, seed = 2, 128, 1, 1, 4, 38282
        m = 2 * nch
        rng = np.random.default_rng(seed)
        x = _noise_int8((a, p, (nb + taps - 1) * m), seed=seed)
        w = pfb_window(taps, m)
        fd = rng.uniform(-0.5, 0.5, (a, p, nb))
        ph = rng.uniform(-np.pi, np.pi, (a, p, nb))
        g = np.full(nch, 0.05) * np.exp(1j * rng.uniform(-np.pi, np.pi, nch))
        ref = golden.f_engine(x, w, taps, nch, frac_delay=fd, phase=ph,
                              gains=g)
        out = jx_f_engine(jnp.asarray(x), w, taps, nch,
                          frac_delay=jnp.asarray(fd, jnp.float32),
                          phase=jnp.asarray(ph, jnp.float32),
                          gains=jnp.asarray(np_c2ri(g)))
        outc = np_ri2c(out)
        assert snr_db(ref, outc) > 50
        d = outc - ref
        pre = golden.f_engine(x, w, taps, nch, frac_delay=fd, phase=ph) * g
        for i in map(tuple, np.argwhere(np.abs(d) > 0)):
            for comp, dd in ((pre[i].real, d[i].real),
                             (pre[i].imag, d[i].imag)):
                if dd:
                    assert abs(dd) <= 1, (i, dd)
                    assert abs(comp - np.floor(comp) - 0.5) < 1e-3, (i, comp)
