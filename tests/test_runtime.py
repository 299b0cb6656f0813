"""Integration level (SURVEY.md §4.2): the chunked streaming runner vs the
golden chain on the whole stream — chunking must be invisible, dumps must
bookkeep, faults must stay consistent, checkpoints must resume."""

import numpy as np
import pytest
import jax.numpy as jnp

from dc_sand_tpu import golden
from dc_sand_tpu.config import ChainConfig
from dc_sand_tpu.runtime import DelayModel, FXRunner, save_state, load_state
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu.utils import snr_db, np_ri2c

N_CHANS = 64
M = 2 * N_CHANS
TAPS = 4
B_CHUNK = 4  # spectra per chunk


def _cfg(**kw):
    base = dict(name="t", n_ants=3, n_pols=2, n_chans=N_CHANS, n_taps=TAPS,
                spectra_per_chunk=B_CHUNK, n_spectra_per_acc=2 * B_CHUNK,
                apply_delay=True, apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _make_stream(cfg, n_chunks, seed=0):
    shape = (cfg.n_ants, cfg.n_pols, n_chunks * cfg.chunk_samples)
    return golden.quantize_adc(golden.gaussian_noise(shape, 20.0, seed))


def _source(stream, cfg):
    c = cfg.chunk_samples
    return lambda i: stream[..., i * c:(i + 1) * c]


def _golden_chain(cfg, stream, dm, gains, n_chunks):
    """Golden reference for the runner — delegates to the verify
    module's oracle (per-chunk coarse delay, correct for drifting
    models too) so the suite has ONE oracle that cannot drift from
    the one the CLI grades against."""
    from dc_sand_tpu.verify import _golden_spectra
    return _golden_spectra(cfg, stream, dm, gains, n_chunks,
                           pfb_window(cfg.n_taps, cfg.fft_size,
                                      cfg.window))


class TestRunnerFX:
    def test_vis_dumps_match_golden(self):
        cfg = _cfg()
        n_chunks = 4
        rng = np.random.default_rng(5)
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 = rng.integers(0, 8, (cfg.n_ants, cfg.n_pols)).astype(float)
        dm.p1 = rng.uniform(-1e-6, 1e-6, (cfg.n_ants, cfg.n_pols))
        gains = np.full(cfg.n_chans, 0.05) + 0j
        gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
        stream = _make_stream(cfg, n_chunks, seed=6)
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)

        runner = FXRunner(cfg, w, delay_model=dm, gains=gains_ri)
        dumps, counters = runner.run(_source(stream, cfg), n_chunks)

        assert counters.chunks_in == 4 and counters.dumps == 2
        spec_g = _golden_chain(cfg, stream, dm, gains, n_chunks)
        bpa = cfg.n_spectra_per_acc
        for d_i, dump in enumerate(dumps):
            win = spec_g[:, :, d_i * bpa:(d_i + 1) * bpa]
            vis_g = golden.xcorr(win)
            vis = dump.vis[..., 0] + 1j * dump.vis[..., 1]
            assert dump.n_spectra == bpa
            assert snr_db(vis_g, vis) > 50

    def test_fault_injected_drop_keeps_books(self):
        cfg = _cfg()
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols)
        stream = _make_stream(cfg, 4, seed=7)
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        runner = FXRunner(cfg, w, delay_model=dm)
        dumps, counters = runner.run(_source(stream, cfg), 4,
                                     drop_chunks=[1])
        assert counters.chunks_dropped == 1
        assert dumps[0].n_spectra == B_CHUNK          # half window lost
        assert dumps[0].n_spectra_nominal == 2 * B_CHUNK
        assert dumps[1].n_spectra == 2 * B_CHUNK
        # golden: chunk 1 replaced by zeros
        faulted = stream.copy()
        c = cfg.chunk_samples
        faulted[..., c:2 * c] = 0
        spec_g = _golden_chain(cfg, faulted, dm,
                               np.full(cfg.n_chans, cfg.quant_scale) + 0j, 4)
        vis_g = golden.xcorr(spec_g[:, :, :2 * B_CHUNK])
        vis = dumps[0].vis[..., 0] + 1j * dumps[0].vis[..., 1]
        assert snr_db(vis_g, vis) > 50

    def test_checkpoint_resume_identical(self, tmp_path):
        cfg = _cfg()
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols)
        stream = _make_stream(cfg, 4, seed=8)
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        src = _source(stream, cfg)

        straight = FXRunner(cfg, w, delay_model=dm)
        dumps_a, _ = straight.run(src, 4)

        first = FXRunner(cfg, w, delay_model=dm)
        first.run(src, 2)
        ckpt = str(tmp_path / "state.npz")
        save_state(first, ckpt)

        resumed = FXRunner(cfg, w, delay_model=dm)
        load_state(resumed, ckpt)
        assert resumed.chunk_idx == 2
        dumps_b, _ = resumed.run(src, 2)

        np.testing.assert_array_equal(dumps_a[1].vis, dumps_b[0].vis)

    def test_run_batched_equals_streaming(self):
        """The offline scan path (one dispatch per dump window) equals
        the per-chunk streaming run bitwise — same carry semantics,
        drop bookkeeping, and dump extraction."""
        ntaps = 4
        cfg = _cfg(n_chans=N_CHANS, n_taps=ntaps, spectra_per_chunk=8,
                   n_spectra_per_acc=16)
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 2.0
        dm.d1 += 0.002
        stream = _make_stream(cfg, 4, seed=31)
        w = pfb_window(ntaps, cfg.fft_size, cfg.window)
        src = _source(stream, cfg)
        import copy
        r1 = FXRunner(cfg, w, delay_model=copy.deepcopy(dm))
        d1, c1 = r1.run(src, 4, drop_chunks=[1])
        r2 = FXRunner(cfg, w, delay_model=copy.deepcopy(dm))
        d2, c2 = r2.run_batched(src, 4, drop_chunks=[1])
        assert len(d1) == len(d2) == 2
        for a, b in zip(d1, d2):
            np.testing.assert_array_equal(a.vis, b.vis)
            assert a.n_spectra == b.n_spectra
            assert a.first_chunk == b.first_chunk
        assert c1.chunks_in == c2.chunks_in
        assert c1.chunks_dropped == c2.chunks_dropped == 1

    def test_checkpoint_resume_with_drifting_delay(self, tmp_path):
        """Resume across a checkpoint with a DRIFTING delay model
        (d1 != 0, coarse delay changes mid-stream): the checkpoint must
        carry the polynomials — the resumed runner is built with a
        zeroed model and still reproduces the straight run bitwise."""
        cfg = _cfg()
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 2.0
        dm.d1 += 0.003   # coarse crosses 2 -> 7 over four 512-samp chunks
        dm.p1 += 1e-5
        stream = _make_stream(cfg, 4, seed=12)
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        src = _source(stream, cfg)

        import copy
        straight = FXRunner(cfg, w, delay_model=copy.deepcopy(dm))
        dumps_a, _ = straight.run(src, 4)

        first = FXRunner(cfg, w, delay_model=copy.deepcopy(dm))
        first.run(src, 2)
        ckpt = str(tmp_path / "state.npz")
        save_state(first, ckpt)

        # fresh-process semantics: the resumed runner starts with a
        # zeroed delay model; load_state must restore the real one
        resumed = FXRunner(
            cfg, w,
            delay_model=DelayModel.zeros(cfg.n_ants, cfg.n_pols,
                                         max_delay=8))
        load_state(resumed, ckpt)
        assert resumed.delay_model.d1[0, 0] == pytest.approx(0.003)
        assert resumed.counters.chunks_in == 2
        dumps_b, _ = resumed.run(src, 2)
        np.testing.assert_array_equal(dumps_a[1].vis, dumps_b[0].vis)

    def test_quadratic_drift_resume_and_golden(self, tmp_path):
        """SURVEY C2/C12 'time-varying delay polynomial': a QUADRATIC
        model (d2, p2 != 0 — geometric acceleration between tracker
        handoffs) must (a) track the per-chunk-coarse golden oracle and
        (b) survive a checkpoint/resume bitwise, including the epoch
        t_ref."""
        from dc_sand_tpu.verify import _golden_coarse_stream
        import copy
        cfg = _cfg()
        n_chunks = 4
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 1.0
        dm.d1 += 0.001
        dm.d2 += 8e-7    # coarse sweeps ~1 -> ~5 over four 512-s chunks
        dm.p1 += 1e-5
        dm.p2 += 3e-9
        dm.t_ref = 0
        gains = np.full(cfg.n_chans, 0.05) + 0j
        gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
        stream = _make_stream(cfg, n_chunks, seed=17)
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        runner = FXRunner(cfg, w, delay_model=copy.deepcopy(dm),
                          gains=gains_ri)
        dumps, _ = runner.run(_source(stream, cfg), n_chunks)

        # (a) golden oracle with the same quadratic evaluation
        delayed = _golden_coarse_stream(cfg, stream, dm, n_chunks)
        fracs, phases = [], []
        for i in range(n_chunks):
            _, f, p = dm.evaluate_chunk(i * cfg.chunk_samples,
                                        cfg.spectra_per_chunk,
                                        cfg.fft_size)
            fracs.append(f)
            phases.append(p)
        lead = (cfg.n_taps - 1) * cfg.fft_size
        xg = np.concatenate(
            [np.zeros(delayed.shape[:-1] + (lead,)), delayed], axis=-1)
        spec_g = golden.f_engine(
            xg, w, cfg.n_taps, cfg.n_chans,
            frac_delay=np.concatenate(fracs, -1),
            phase=np.concatenate(phases, -1), gains=gains)
        bpa = cfg.n_spectra_per_acc
        for d_i, dump in enumerate(dumps):
            vis_g = golden.xcorr(spec_g[:, :, d_i * bpa:(d_i + 1) * bpa])
            vis = dump.vis[..., 0] + 1j * dump.vis[..., 1]
            assert snr_db(vis_g, vis) > 50

        # (b) resume mid-stream: d2/p2/t_ref ride the checkpoint
        src = _source(stream, cfg)
        first = FXRunner(cfg, w, delay_model=copy.deepcopy(dm),
                         gains=gains_ri)
        first.run(src, 2)
        ckpt = str(tmp_path / "quad.npz")
        save_state(first, ckpt)
        resumed = FXRunner(
            cfg, w, delay_model=DelayModel.zeros(
                cfg.n_ants, cfg.n_pols, max_delay=8),
            gains=gains_ri)
        load_state(resumed, ckpt)
        assert resumed.delay_model.d2[0, 0] == pytest.approx(8e-7)
        dumps_b, _ = resumed.run(src, 2)
        np.testing.assert_array_equal(dumps[1].vis, dumps_b[0].vis)

    def test_polynomial_handoff_continuity(self):
        """DelayModel.update() recenters the live polynomials to the new
        epoch exactly: a handoff that changes NO coefficients evaluates
        identically before and after (no delay jump at the boundary),
        and a full handoff takes effect in the new epoch's frame."""
        dm = DelayModel.zeros(1, 1, max_delay=8)
        dm.d0 += 1.0
        dm.d1 += 1e-3
        dm.d2 += 2e-7
        dm.p1 += 1e-5
        dm.p2 += 4e-9
        c0, f0, ph0 = dm.evaluate_chunk(4096, 8, 128)
        dm.update(t_ref=4096)   # pure recenter, no coefficient change
        c1, f1, ph1 = dm.evaluate_chunk(4096, 8, 128)
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_allclose(f0, f1, atol=1e-6)
        np.testing.assert_allclose(ph0, ph1, atol=1e-6)
        # full handoff: new coefficients are in the NEW epoch's frame
        dm.update(t_ref=8192, d0=3.0, d1=0.0, d2=0.0, p0=0.5, p1=0.0,
                  p2=0.0)
        c2, f2, ph2 = dm.evaluate_chunk(8192, 2, 128)
        assert c2[0, 0] == 3
        np.testing.assert_allclose(f2, 0.0, atol=1e-6)
        np.testing.assert_allclose(ph2, 0.5, atol=1e-6)

    def test_drifting_coarse_matches_golden(self):
        """d1 != 0 end-to-end vs the per-chunk-coarse golden oracle
        (the whole-stream single-coarse oracle would be wrong here —
        round-1 ADVICE item)."""
        from dc_sand_tpu.verify import _golden_coarse_stream
        cfg = _cfg()
        n_chunks = 4
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 1.0
        dm.d1 += 0.003
        gains = np.full(cfg.n_chans, 0.05) + 0j
        gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
        stream = _make_stream(cfg, n_chunks, seed=13)
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        runner = FXRunner(cfg, w, delay_model=dm, gains=gains_ri)
        dumps, _ = runner.run(_source(stream, cfg), n_chunks)

        delayed = _golden_coarse_stream(cfg, stream, dm, n_chunks)
        fracs, phases = [], []
        for i in range(n_chunks):
            _, f, p = dm.evaluate_chunk(i * cfg.chunk_samples,
                                        cfg.spectra_per_chunk,
                                        cfg.fft_size)
            fracs.append(f)
            phases.append(p)
        lead = (cfg.n_taps - 1) * cfg.fft_size
        xg = np.concatenate(
            [np.zeros(delayed.shape[:-1] + (lead,)), delayed], axis=-1)
        spec_g = golden.f_engine(
            xg, w, cfg.n_taps, cfg.n_chans,
            frac_delay=np.concatenate(fracs, -1),
            phase=np.concatenate(phases, -1), gains=gains)
        bpa = cfg.n_spectra_per_acc
        for d_i, dump in enumerate(dumps):
            vis_g = golden.xcorr(spec_g[:, :, d_i * bpa:(d_i + 1) * bpa])
            vis = dump.vis[..., 0] + 1j * dump.vis[..., 1]
            assert snr_db(vis_g, vis) > 50

    def test_checkpoint_wrong_config_rejected(self, tmp_path):
        cfg = _cfg()
        w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        r = FXRunner(cfg, w)
        ckpt = str(tmp_path / "s.npz")
        save_state(r, ckpt)
        other = FXRunner(cfg.replace(n_chans=32),
                         pfb_window(cfg.n_taps, 64, cfg.window))
        with pytest.raises(ValueError, match="config hash"):
            load_state(other, ckpt)


class TestRunnerFEngine:
    def test_chunking_invariance(self):
        """Spectra from 4 small chunks == spectra from 1 big chunk."""
        base = dict(name="t", n_ants=2, n_pols=1, n_chans=N_CHANS,
                    n_taps=TAPS, apply_delay=False, apply_requant=False)
        cfg_small = ChainConfig(spectra_per_chunk=B_CHUNK, **base)
        cfg_big = ChainConfig(spectra_per_chunk=4 * B_CHUNK, **base)
        stream = _make_stream(cfg_small, 4, seed=9)
        w = pfb_window(TAPS, M)

        outs = []
        r1 = FXRunner(cfg_small, w)
        r1.run(_source(stream, cfg_small), 4,
               on_output=lambda i, o: outs.append(o["spectra"]))
        small = np.concatenate(outs, axis=2)

        outs2 = []
        r2 = FXRunner(cfg_big, w)
        r2.run(_source(stream, cfg_big), 1,
               on_output=lambda i, o: outs2.append(o["spectra"]))
        big = outs2[0]
        np.testing.assert_array_equal(small, big)

    def test_beam_mode_outputs(self):
        cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=B_CHUNK,
                          apply_delay=True, apply_requant=True, n_beams=2,
                          incoherent_beam=True)
        rng = np.random.default_rng(10)
        wts = rng.normal(size=(2, 4, N_CHANS, 2)).astype(np.float32)
        stream = _make_stream(cfg, 2, seed=11)
        w = pfb_window(TAPS, M)
        outs = []
        r = FXRunner(cfg, w, weights=wts)
        r.run(_source(stream, cfg), 2,
              on_output=lambda i, o: outs.append(o))
        assert outs[0]["beams"].shape == (2, 2, B_CHUNK, N_CHANS, 2)
        assert outs[0]["incoherent"].shape == (2, B_CHUNK, N_CHANS)
        # golden check on the second chunk (first has cold-start history)
        spec_g = _golden_chain(
            cfg, stream, DelayModel.zeros(cfg.n_ants, cfg.n_pols),
            np.full(cfg.n_chans, cfg.quant_scale) + 0j, 2)
        wg = wts[..., 0] + 1j * wts[..., 1]
        beams_g = golden.beamform(spec_g[:, :, B_CHUNK:], wg)
        beams = np_ri2c(outs[1]["beams"])
        assert snr_db(beams_g, beams) > 50
        inc_g = golden.incoherent_sum(spec_g[:, :, B_CHUNK:])
        assert snr_db(inc_g, outs[1]["incoherent"]) > 50

    def test_mid_run_repointing(self):
        """Beam weights are host-updatable between chunks (SURVEY C12:
        'updated per chunk') — re-pointing mid-run takes effect on the
        next chunk with no rebuild."""
        import jax.numpy as jnp
        cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=B_CHUNK,
                          apply_delay=False, apply_requant=True,
                          n_beams=2)
        rng = np.random.default_rng(14)
        w1 = rng.normal(size=(2, 4, N_CHANS, 2)).astype(np.float32)
        w2 = rng.normal(size=(2, 4, N_CHANS, 2)).astype(np.float32)
        stream = _make_stream(cfg, 3, seed=15)
        outs = []
        r = FXRunner(cfg, pfb_window(TAPS, M), weights=w1)

        def on_out(i, o):
            outs.append(o)
            if i == 1:
                r.weights = jnp.asarray(w2)     # re-point mid-run

        r.run(_source(stream, cfg), 3, on_output=on_out)
        spec_g = _golden_chain(
            cfg, stream, DelayModel.zeros(cfg.n_ants, cfg.n_pols),
            np.full(cfg.n_chans, cfg.quant_scale) + 0j, 3)
        for ci, wts in ((1, w1), (2, w2)):      # chunk 2 uses w2
            sl = spec_g[:, :, ci * B_CHUNK:(ci + 1) * B_CHUNK]
            ref = golden.beamform(sl, wts[..., 0] + 1j * wts[..., 1])
            assert snr_db(ref, np_ri2c(outs[ci]["beams"])) > 50, ci

    def test_beam_stokes_matches_golden(self):
        """cfg.beam_stokes emits I/Q/U/V detection on the float beam
        voltages (C10 downstream product), vs golden.stokes."""
        cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=B_CHUNK,
                          apply_delay=False, apply_requant=True,
                          n_beams=2, beam_stokes=True)
        rng = np.random.default_rng(12)
        wts = rng.normal(size=(2, 4, N_CHANS, 2)).astype(np.float32)
        stream = _make_stream(cfg, 2, seed=13)
        outs = []
        r = FXRunner(cfg, pfb_window(TAPS, M), weights=wts)
        r.run(_source(stream, cfg), 2,
              on_output=lambda i, o: outs.append(o))
        assert outs[0]["stokes"].shape == (2, 4, B_CHUNK, N_CHANS)
        spec_g = _golden_chain(
            cfg, stream, DelayModel.zeros(cfg.n_ants, cfg.n_pols),
            np.full(cfg.n_chans, cfg.quant_scale) + 0j, 2)
        wg = wts[..., 0] + 1j * wts[..., 1]
        stokes_g = golden.stokes(golden.beamform(spec_g[:, :, B_CHUNK:],
                                                 wg))
        assert snr_db(stokes_g, outs[1]["stokes"]) > 50

    def test_beam_stokes_needs_dual_pol(self):
        from dc_sand_tpu.models.pipeline import make_step
        cfg = ChainConfig(name="t", n_ants=4, n_pols=1, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=B_CHUNK,
                          n_beams=2, beam_stokes=True)
        with pytest.raises(ValueError, match="dual-pol"):
            make_step(cfg, pfb_window(TAPS, M))

class TestSteering:
    def test_steering_weights_cohere_through_beamformer(self):
        """Weights from geometric delays undo a per-antenna phase slope
        (golden-level check tying C10 to C12)."""
        from dc_sand_tpu.models.steering import steering_weights
        fs, nch, n_ants = 1712e6, 64, 4
        rng = np.random.default_rng(30)
        tau = rng.uniform(-1e-9, 1e-9, (1, n_ants))  # one beam
        w = steering_weights(tau, nch, fs)
        assert w.shape == (1, n_ants, nch, 2)
        # a plane wave arriving with delays tau has antenna phases
        # e^(-2 pi i f tau); the steering weights conjugate them
        f = np.arange(nch) * fs / (2 * nch)
        sig = np.exp(-2j * np.pi * tau[0][:, None] * f)  # (ant, k)
        x = sig[:, None, None, :] * np.ones((n_ants, 1, 3, nch))
        y = golden.beamform(x, w[..., 0] + 1j * w[..., 1])
        np.testing.assert_allclose(np.abs(y[0, 0]), n_ants, rtol=1e-6)

    def test_bad_shape_rejected(self):
        from dc_sand_tpu.models.steering import steering_weights
        with pytest.raises(ValueError):
            steering_weights(np.zeros(3), 16, 1e9)


class TestBeamQuant:
    def test_int8_beam_output_matches_golden(self):
        cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=B_CHUNK,
                          apply_delay=True, apply_requant=True, n_beams=2,
                          beam_quant_scale=0.25)
        rng = np.random.default_rng(40)
        wts = rng.normal(size=(2, 4, N_CHANS, 2)).astype(np.float32)
        stream = _make_stream(cfg, 2, seed=41)
        w = pfb_window(TAPS, M)
        outs = []
        r = FXRunner(cfg, w, weights=wts)
        r.run(_source(stream, cfg), 2, on_output=lambda i, o: outs.append(o))
        assert outs[0]["beams"].dtype == np.int8
        spec_g = _golden_chain(
            cfg, stream, DelayModel.zeros(cfg.n_ants, cfg.n_pols),
            np.full(cfg.n_chans, cfg.quant_scale) + 0j, 2)
        wg = wts[..., 0] + 1j * wts[..., 1]
        beams_g = golden.requantize(
            golden.beamform(spec_g[:, :, B_CHUNK:], wg), 0.25)
        got = np_ri2c(outs[1]["beams"].astype(np.float64))
        assert snr_db(beams_g, got) > 50


class TestHeadroom:
    def test_overflow_window_rejected(self):
        cfg = _cfg(n_spectra_per_acc=70000, spectra_per_chunk=4)
        with pytest.raises(ValueError, match="overflow"):
            FXRunner(cfg, pfb_window(TAPS, M))

    def test_max_amplitude_exact(self):
        """Full-scale +/-127 inputs integrate exactly (no silent wrap)."""
        import jax.numpy as jnp2
        from dc_sand_tpu import ops as _ops
        b = 64
        q = np.full((8, 2, b, 4, 2), 127, np.int8)  # (ant,pol,b,k,2)
        q[..., 1] = -127
        v = np.asarray(_ops.xcorr(jnp2.asarray(np.moveaxis(q, 3, 0),
                                               jnp2.int8)))
        expect = 2 * 127 * 127 * b
        assert v.max() == expect and abs(int(v.min())) <= expect


class TestRunnerFuzz:
    """Property fuzz over the runner's drop/dump/cadence state machine:
    arbitrary drop sets x window lengths x coarse delays must keep the
    integration bookkeeping exact and the visibilities equal to the
    golden chain run on the same zero-filled stream (a dropped chunk is
    zeros, but its FIR history still smears the previous chunk's
    samples into the window — the oracle sees exactly that)."""

    def test_drop_cadence_fuzz(self):
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=12, deadline=None)
        @given(
            g=st.integers(1, 3),            # chunks per dump window
            n_dumps=st.integers(1, 2),
            extra=st.integers(0, 2),        # trailing partial window
            drops=st.sets(st.integers(0, 7), max_size=4),
            seed=st.integers(0, 2**16),
        )
        def case(g, n_dumps, extra, drops, seed):
            n_chunks = g * n_dumps + min(extra, g - 1)
            drops = {d for d in drops if d < n_chunks}
            cfg = _cfg(n_spectra_per_acc=g * B_CHUNK)
            rng = np.random.default_rng(seed)
            dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
            dm.d0 = rng.integers(0, 8,
                                 (cfg.n_ants, cfg.n_pols)).astype(float)
            stream = _make_stream(cfg, n_chunks, seed=seed)
            w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
            runner = FXRunner(cfg, w, delay_model=dm)
            dumps, counters = runner.run(_source(stream, cfg), n_chunks,
                                         drop_chunks=drops)
            assert counters.chunks_dropped == len(drops)
            assert counters.chunks_in == n_chunks
            assert len(dumps) == n_dumps
            # golden on the SAME zero-filled stream
            faulted = stream.copy()
            c = cfg.chunk_samples
            for d in drops:
                faulted[..., d * c:(d + 1) * c] = 0
            gains = np.full(cfg.n_chans, cfg.quant_scale) + 0j
            spec_g = _golden_chain(cfg, faulted, dm, gains, n_chunks)
            bpa = cfg.n_spectra_per_acc
            for di, dump in enumerate(dumps):
                lost = sum(1 for d in drops if di * g <= d < (di + 1) * g)
                assert dump.first_chunk == di * g
                assert dump.n_spectra_nominal == bpa
                assert dump.n_spectra == B_CHUNK * (g - lost)
                vis_g = golden.xcorr(spec_g[:, :, di * bpa:(di + 1) * bpa])
                vis = np_ri2c(dump.vis)
                if np.abs(vis_g).max() > 1e-6:
                    assert snr_db(vis_g, vis) > 50
                else:   # fully-dark window: exact zeros, not noise
                    assert np.abs(vis).max() == 0

        case()
