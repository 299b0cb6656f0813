"""Sharded-semantics level (SURVEY.md §4.2): halo exchange, corner-turn
all-to-all and the full sharded FX pipeline on a simulated 8-device CPU
mesh must equal the unsharded golden computation."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dc_sand_tpu import golden
from dc_sand_tpu.parallel import (build_mesh, FX_AXIS, TIME_AXIS,
                                  corner_turn_all_to_all,
                                  halo_exchange_left)
from dc_sand_tpu.models.fx import (fx_step_local, make_sharded_fx_step,
                                   make_time_sharded_fengine)
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu.utils import snr_db, np_c2ri, np_ri2c

shard_map_fn = jax.shard_map

N_CHANS = 128
M = 2 * N_CHANS
TAPS = 4


def _noise_int8(shape, seed=0, sigma=20.0):
    return golden.quantize_adc(golden.gaussian_noise(shape, sigma, seed))


class TestHalo:
    def test_halo_matches_neighbor_tail(self):
        mesh = build_mesh(n_devices=4, time_shards=4)
        t_local = 32
        x = jnp.arange(4 * t_local, dtype=jnp.float32).reshape(1, -1)

        fn = jax.jit(shard_map_fn(
            lambda xl: halo_exchange_left(xl, 8, TIME_AXIS),
            mesh=mesh, in_specs=(P(None, TIME_AXIS),),
            out_specs=P(None, TIME_AXIS)))
        out = np.asarray(fn(x)).reshape(4, -1)  # (shard, 8 + t_local)
        xs = np.asarray(x).reshape(4, t_local)
        np.testing.assert_array_equal(out[0, :8], 0.0)  # cold start
        for i in range(1, 4):
            np.testing.assert_array_equal(out[i, :8], xs[i - 1, -8:])
            np.testing.assert_array_equal(out[i, 8:], xs[i])


class TestCornerTurn:
    def test_all_to_all_is_transpose(self):
        d = 4
        mesh = build_mesh(n_devices=d)
        a, pol, b, k = 8, 2, 3, 64
        rng = np.random.default_rng(0)
        q = jnp.asarray(rng.integers(-100, 100, (a, pol, b, k, 2)), jnp.int8)

        fn = jax.jit(shard_map_fn(
            lambda ql: corner_turn_all_to_all(ql, FX_AXIS),
            mesh=mesh, in_specs=(P(FX_AXIS),),
            out_specs=P(None, None, None, FX_AXIS)))
        out = np.asarray(fn(q))
        # logically the identity on the global array (pure re-shard)
        np.testing.assert_array_equal(out, np.asarray(q))
        # and the device-local blocks are channel-major slices
        shards = [np.asarray(s.data) for s in fn(q).addressable_shards]
        assert shards[0].shape == (a, pol, b, k // d, 2)


class TestShardedFX:
    def test_matches_golden_full_chain(self):
        d = 4
        mesh = build_mesh(n_devices=d)
        n_ants, n_pols, nb = 8, 2, 8
        n = (nb + TAPS - 1) * M + 16
        rng = np.random.default_rng(1)
        x = _noise_int8((n_ants, n_pols, n), seed=2)
        cd = rng.integers(0, 16, (n_ants, n_pols))
        fd = rng.uniform(-0.5, 0.5, (n_ants, n_pols, nb))
        ph = rng.uniform(-np.pi, np.pi, (n_ants, n_pols, nb))
        g = np.full(N_CHANS, 0.05) * np.exp(
            1j * rng.uniform(-np.pi, np.pi, N_CHANS))
        w = pfb_window(TAPS, M)

        spec_g = golden.f_engine(x, w, TAPS, N_CHANS, coarse_delays=cd,
                                 max_delay=16, frac_delay=fd, phase=ph,
                                 gains=g)
        vis_g = golden.xcorr(spec_g)

        step = make_sharded_fx_step(mesh, w, TAPS, N_CHANS, n_ants, max_delay=16)
        vis = np.asarray(step(jnp.asarray(x), jnp.asarray(fd, jnp.float32),
                              jnp.asarray(ph, jnp.float32),
                              jnp.asarray(np_c2ri(g)),
                              jnp.asarray(cd, jnp.int32)))
        vis_c = vis[..., 0] + 1j * vis[..., 1]
        assert vis_c.shape == vis_g.shape
        # requant rounding can differ by 1 LSB fp32-vs-fp64 on boundary
        # values; SNR is the contract metric (BASELINE.json:5)
        assert snr_db(vis_g, vis_c) > 50

    def test_sharded_equals_local(self):
        """Bitwise: sharded pipeline == same pipeline on one device."""
        d = 4
        mesh = build_mesh(n_devices=d)
        n_ants, n_pols, nb = 8, 1, 8
        n = (nb + TAPS - 1) * M
        x = _noise_int8((n_ants, n_pols, n), seed=3)
        w = pfb_window(TAPS, M)
        gains = np.zeros((N_CHANS, 2), np.float32)
        gains[:, 0] = 0.05
        fd = np.zeros((n_ants, n_pols, nb), np.float32)
        ph = np.zeros((n_ants, n_pols, nb), np.float32)
        cd = np.zeros((n_ants, n_pols), np.int32)

        local = fx_step_local(jnp.asarray(x), w, TAPS, N_CHANS,
                              frac_delay=jnp.asarray(fd),
                              phase=jnp.asarray(ph),
                              gains=jnp.asarray(gains))
        step = make_sharded_fx_step(mesh, w, TAPS, N_CHANS, n_ants)
        sharded = step(jnp.asarray(x), jnp.asarray(fd), jnp.asarray(ph),
                       jnp.asarray(gains), jnp.asarray(cd))
        np.testing.assert_array_equal(np.asarray(local),
                                      np.asarray(sharded))


class TestSPStreamingMode:
    """First-class sequence-parallel streaming (cfg.time_shards): the
    carried FIR history crosses chunk boundaries through the halo ring,
    so a time-sharded stream equals the unsharded stream BITWISE at
    streaming cadence — no cold start except chunk 0 (VERDICT r1 #5)."""

    def _run(self, cfg, mesh, stream, n_chunks):
        from dc_sand_tpu.runtime import FXRunner
        outs = []
        r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size), mesh=mesh)
        r.run(lambda i: stream[..., i * cfg.chunk_samples:
                               (i + 1) * cfg.chunk_samples], n_chunks,
              on_output=lambda i, o: outs.append(o))
        return outs

    def test_sp_equals_unsharded_across_chunks(self):
        from dc_sand_tpu.config import ChainConfig
        d = 4
        mesh = build_mesh(n_devices=d, time_shards=d)
        base = dict(name="t", n_ants=2, n_pols=2, n_chans=N_CHANS,
                    n_taps=TAPS, spectra_per_chunk=4 * d,
                    apply_delay=True, apply_requant=True)
        cfg_sp = ChainConfig(time_shards=d, **base)
        cfg_1 = ChainConfig(**base)
        n_chunks = 3
        stream = _noise_int8(
            (2, 2, n_chunks * cfg_sp.chunk_samples), seed=80)
        sp = self._run(cfg_sp, mesh, stream, n_chunks)
        ref = self._run(cfg_1, None, stream, n_chunks)
        for c in range(n_chunks):
            np.testing.assert_array_equal(sp[c]["spectra"],
                                          ref[c]["spectra"])

    def test_sp_beam_mode(self):
        from dc_sand_tpu.config import ChainConfig
        d = 2
        mesh = build_mesh(n_devices=d, time_shards=d)
        base = dict(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                    n_taps=TAPS, spectra_per_chunk=4 * d, n_beams=2,
                    apply_delay=True, apply_requant=True,
                    incoherent_beam=True, beam_stokes=True)
        rng = np.random.default_rng(81)
        wts = rng.normal(size=(2, 4, N_CHANS, 2)).astype(np.float32)
        stream = _noise_int8((4, 2, 2 * 4 * d * M), seed=82)
        from dc_sand_tpu.runtime import FXRunner

        def run(cfg, mesh_):
            outs = []
            r = FXRunner(cfg, pfb_window(TAPS, M), weights=wts,
                         mesh=mesh_)
            r.run(lambda i: stream[..., i * cfg.chunk_samples:
                                   (i + 1) * cfg.chunk_samples], 2,
                  on_output=lambda i, o: outs.append(o))
            return outs

        sp = run(ChainConfig(time_shards=d, **base), mesh)
        ref = run(ChainConfig(**base), None)
        for c in range(2):
            np.testing.assert_allclose(sp[c]["beams"], ref[c]["beams"],
                                       rtol=1e-6, atol=1e-4)
            np.testing.assert_allclose(sp[c]["incoherent"],
                                       ref[c]["incoherent"],
                                       rtol=1e-6, atol=1e-4)
            np.testing.assert_allclose(sp[c]["stokes"],
                                       ref[c]["stokes"],
                                       rtol=1e-6, atol=1e-4)

    def test_sp_fx_dumps_bitwise(self):
        """SP x TP: the fx correlator composed with time sharding on a
        (time=2, fx=4) mesh — antennas sharded over fx before the
        corner-turn, channels after, stream segments over time; each
        time shard integrates its own partial accumulator and the dump
        extraction sums them, so dumps equal the unsharded runner
        BITWISE (int8 F-engine output + exact int32 CMAC)."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        d_t = 2
        mesh = build_mesh(n_devices=8, time_shards=d_t)   # (2, 4)
        base = dict(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                    n_taps=TAPS, spectra_per_chunk=8,
                    n_spectra_per_acc=16, run_xengine=True,
                    apply_delay=True, apply_requant=True)
        n_chunks = 4
        stream = _noise_int8(
            (4, 2, n_chunks * 8 * M), seed=90)

        def run(cfg, mesh_):
            r = FXRunner(cfg, pfb_window(TAPS, M), mesh=mesh_)
            dumps, _ = r.run(
                lambda i: stream[..., i * cfg.chunk_samples:
                                 (i + 1) * cfg.chunk_samples], n_chunks)
            return dumps

        sp = run(ChainConfig(time_shards=d_t, **base), mesh)
        ref = run(ChainConfig(**base), None)
        assert len(sp) == len(ref) == 2
        for ds, dr in zip(sp, ref):
            assert np.any(dr.vis)
            np.testing.assert_array_equal(ds.vis, dr.vis)
            assert ds.n_spectra == dr.n_spectra

    def test_sp_ep_beam(self):
        """SP x EP: beam_parallel composed with time sharding — beams
        psum_scattered over fx per time shard; matches the unsharded
        beam step."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        mesh = build_mesh(n_devices=8, time_shards=2)   # (2, 4)
        base = dict(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                    n_taps=TAPS, spectra_per_chunk=8, n_beams=4,
                    apply_delay=True, apply_requant=True,
                    incoherent_beam=True, beam_stokes=True)
        rng = np.random.default_rng(91)
        wts = rng.normal(size=(4, 4, N_CHANS, 2)).astype(np.float32)
        stream = _noise_int8((4, 2, 2 * 8 * M), seed=92)

        def run(cfg, mesh_):
            outs = []
            r = FXRunner(cfg, pfb_window(TAPS, M), weights=wts,
                         mesh=mesh_)
            r.run(lambda i: stream[..., i * cfg.chunk_samples:
                                   (i + 1) * cfg.chunk_samples], 2,
                  on_output=lambda i, o: outs.append(o))
            return outs

        sp = run(ChainConfig(time_shards=2, beam_parallel=True, **base),
                 mesh)
        ref = run(ChainConfig(**base), None)
        for c in range(2):
            # the 4-way psum_scatter reduces in a different order than
            # the unsharded antenna sum: int8 beams may differ 1 LSB at
            # quantisation boundaries, stokes products (near-cancelling
            # Q/U/V differences of large squares) carry the fp32 noise
            np.testing.assert_allclose(np.asarray(sp[c]["beams"]),
                                       np.asarray(ref[c]["beams"]),
                                       atol=1)
            np.testing.assert_allclose(np.asarray(sp[c]["stokes"]),
                                       np.asarray(ref[c]["stokes"]),
                                       rtol=1e-3, atol=0.5)
            np.testing.assert_allclose(np.asarray(sp[c]["incoherent"]),
                                       np.asarray(ref[c]["incoherent"]),
                                       rtol=1e-5, atol=1e-4)

    def test_sp_fengine_2d_mesh(self):
        """SP x DP: antennas sharded over fx AND time over the stream on
        the same 2D mesh — spectra bitwise vs unsharded."""
        from dc_sand_tpu.config import ChainConfig
        mesh = build_mesh(n_devices=8, time_shards=2)   # (2, 4)
        base = dict(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                    n_taps=TAPS, spectra_per_chunk=8,
                    apply_delay=True, apply_requant=True)
        n_chunks = 2
        stream = _noise_int8((4, 2, n_chunks * 8 * M), seed=93)
        sp = self._run(ChainConfig(time_shards=2, **base), mesh,
                       stream, n_chunks)
        ref = self._run(ChainConfig(**base), None, stream, n_chunks)
        for c in range(n_chunks):
            np.testing.assert_array_equal(sp[c]["spectra"],
                                          ref[c]["spectra"])

    def test_sp_fx_run_batched_and_resume(self):
        """The SP fx composition rides the whole runtime surface: the
        scan-window batched path and checkpoint/resume both reproduce
        the streaming dumps bitwise (the per-time-shard partial
        accumulators are part of the carried/checkpointed state)."""
        import tempfile, os
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.runtime.checkpoint import save_state, load_state
        mesh = build_mesh(n_devices=8, time_shards=2)
        cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=8,
                          n_spectra_per_acc=32, run_xengine=True,
                          apply_delay=True, apply_requant=True,
                          time_shards=2)
        w = pfb_window(TAPS, M)
        stream = _noise_int8((4, 2, 8 * cfg.chunk_samples), seed=94)

        def src(i):
            return stream[..., i * cfg.chunk_samples:
                          (i + 1) * cfg.chunk_samples]

        r0 = FXRunner(cfg, w, mesh=mesh)
        d0, _ = r0.run(src, 8)
        # batched scan path
        rb = FXRunner(cfg, w, mesh=mesh)
        db, _ = rb.run_batched(src, 8)
        assert len(d0) == len(db) == 2
        for a, b in zip(d0, db):
            np.testing.assert_array_equal(a.vis, b.vis)
        # checkpoint mid-window, resume in a fresh runner
        r1 = FXRunner(cfg, w, mesh=mesh)
        r1.run(src, 3)
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "ck.npz")
            save_state(r1, p)
            r2 = FXRunner(cfg, w, mesh=mesh)
            load_state(r2, p)
            d2, _ = r2.run(src, 5)
        np.testing.assert_array_equal(d0[-1].vis, d2[-1].vis)

    def test_sp_rejects_indivisible_ants(self):
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.models.pipeline import make_step
        mesh = build_mesh(n_devices=8, time_shards=2)   # fx axis = 4
        cfg = ChainConfig(name="t", n_ants=3, n_pols=1, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=8,
                          time_shards=2)
        with pytest.raises(ValueError, match="divide over the fx"):
            make_step(cfg, pfb_window(TAPS, M), mesh=mesh)


class TestTimeShardedFEngine:
    def test_matches_unsharded_with_cold_start(self):
        d = 4
        mesh = build_mesh(n_devices=d, time_shards=d)
        n_ants, n_pols = 2, 1
        b_local = 4
        t_local = b_local * M
        x = _noise_int8((n_ants, n_pols, d * t_local), seed=4)
        w = pfb_window(TAPS, M)

        fe = make_time_sharded_fengine(mesh, w, TAPS, N_CHANS)
        out = np_ri2c(np.asarray(fe(jnp.asarray(x))))

        # golden equivalent: zero lead-in of (taps-1)*M (stream cold start)
        lead = np.zeros((n_ants, n_pols, (TAPS - 1) * M))
        xg = np.concatenate([lead, x], axis=-1)
        ref = golden.channelize(golden.pfb_fir(xg, w, TAPS, M), N_CHANS)
        assert out.shape == ref.shape
        assert snr_db(ref, out) > 100


class TestShardedBeamStep:
    def test_sharded_beam_step_matches_golden(self):
        """make_step beam mode over the mesh (psum over antenna shards)
        == golden beamformer on the full array."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.models.pipeline import make_step, history_len
        d = 4
        mesh = build_mesh(n_devices=d)
        cfg = ChainConfig(name="t", n_ants=8, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=8, n_beams=3,
                          apply_delay=True, apply_requant=True,
                          incoherent_beam=True, beam_stokes=True)
        rng = np.random.default_rng(50)
        wts = rng.normal(size=(3, 8, N_CHANS, 2)).astype(np.float32)
        stream = _noise_int8((8, 2, cfg.chunk_samples), seed=51)
        gains = np.zeros((N_CHANS, 2), np.float32)
        gains[:, 0] = 0.05
        step = make_step(cfg, pfb_window(TAPS, M), max_delay=0, mesh=mesh, donate=False, coarse_on_host=True)
        hist = jnp.zeros((8, 2, history_len(cfg, 0)), jnp.int8)
        args = (hist, jnp.zeros((1,), jnp.int32), jnp.asarray(stream),
                jnp.zeros((8, 2), jnp.int32),
                jnp.zeros((8, 2, 8), jnp.float32),
                jnp.zeros((8, 2, 8), jnp.float32),
                jnp.asarray(gains), jnp.asarray(wts), jnp.asarray(True))
        _, _, outputs = step(*args)

        lead = np.zeros((8, 2, (TAPS - 1) * M))
        xg = np.concatenate([lead, stream], axis=-1)
        spec_g = golden.f_engine(xg, pfb_window(TAPS, M), TAPS, N_CHANS,
                                 frac_delay=np.zeros((8, 2, 8)),
                                 phase=np.zeros((8, 2, 8)),
                                 gains=np.full(N_CHANS, 0.05) + 0j)
        beams_g = golden.beamform(spec_g, wts[..., 0] + 1j * wts[..., 1])
        assert snr_db(beams_g, np_ri2c(np.asarray(outputs["beams"]))) > 50
        inc_g = golden.incoherent_sum(spec_g)
        assert snr_db(inc_g, np.asarray(outputs["incoherent"])) > 50
        stokes_g = golden.stokes(beams_g)
        assert snr_db(stokes_g, np.asarray(outputs["stokes"])) > 50

    def test_beam_parallel_ep_mode_matches_replicated(self):
        """EP mode (cfg.beam_parallel: psum_scatter over the beam axis)
        == the psum-replicated beam step, and each device's addressable
        shard holds exactly its n_beams/N beam subset."""
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.models.pipeline import make_step, history_len
        d = 4
        mesh = build_mesh(n_devices=d)
        base = ChainConfig(name="t", n_ants=8, n_pols=2, n_chans=N_CHANS,
                           n_taps=TAPS, spectra_per_chunk=8, n_beams=4,
                           apply_delay=True, apply_requant=True,
                           incoherent_beam=True, beam_stokes=True)
        rng = np.random.default_rng(52)
        wts = rng.normal(size=(4, 8, N_CHANS, 2)).astype(np.float32)
        stream = _noise_int8((8, 2, base.chunk_samples), seed=53)
        gains = np.zeros((N_CHANS, 2), np.float32)
        gains[:, 0] = 0.05
        hist = jnp.zeros((8, 2, history_len(base, 0)), jnp.int8)
        args = (hist, jnp.zeros((1,), jnp.int32), jnp.asarray(stream),
                jnp.zeros((8, 2), jnp.int32),
                jnp.zeros((8, 2, 8), jnp.float32),
                jnp.zeros((8, 2, 8), jnp.float32),
                jnp.asarray(gains), jnp.asarray(wts), jnp.asarray(True))
        outs = {}
        for ep in (False, True):
            cfg = base.replace(beam_parallel=True) if ep else base
            step = make_step(cfg, pfb_window(TAPS, M), max_delay=0,
                             mesh=mesh, donate=False,
                             coarse_on_host=True)
            _, _, outs[ep] = step(*args)
        # the EP output is globally identical (psum and psum_scatter
        # reduce in the same ring order on this backend) ...
        for key in ("beams", "stokes", "incoherent"):
            np.testing.assert_allclose(np.asarray(outs[True][key]),
                                       np.asarray(outs[False][key]),
                                       rtol=1e-6, atol=1e-4)
        # ... but beam-sharded: every device holds 1/d of the beam axis
        shards = outs[True]["beams"].addressable_shards
        assert len(shards) == d
        nb = base.n_beams
        for s in shards:
            assert s.data.shape[0] == nb // d
        # the replicated mode keeps whole-beam-axis copies
        rep = outs[False]["beams"].addressable_shards
        assert all(s.data.shape[0] == nb for s in rep)

    def test_beam_parallel_validation(self):
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.models.pipeline import make_step
        import pytest
        mesh = build_mesh(n_devices=4)
        cfg = ChainConfig(name="t", n_ants=8, n_pols=2, n_chans=N_CHANS,
                          n_taps=TAPS, spectra_per_chunk=8, n_beams=3,
                          beam_parallel=True)
        with pytest.raises(ValueError, match="divisible"):
            make_step(cfg, pfb_window(TAPS, M), mesh=mesh)
        with pytest.raises(ValueError, match="beam mode"):
            make_step(cfg.replace(n_beams=0, beam_parallel=True),
                      pfb_window(TAPS, M), mesh=mesh)
        # no mesh: the step would silently run replicated while the
        # caller believes EP is active — must refuse (ADVICE r2)
        with pytest.raises(ValueError, match="requires a mesh"):
            make_step(cfg.replace(n_beams=4), pfb_window(TAPS, M),
                      mesh=None)


class TestCollectivesBench:
    def test_every_collective_runs_on_the_cpu_mesh(self):
        """The C15 microbench suite itself: every op in COLLECTIVES
        (incl. the EP psum_scatter) builds, runs over the 8-device mesh,
        and reports positive bandwidth with sane wire-bytes
        accounting."""
        from dc_sand_tpu.bench.collectives import (bench_collective,
                                                   COLLECTIVES)
        mesh = build_mesh(n_devices=8)
        for op in COLLECTIVES:
            r = bench_collective(op, mesh, mb_per_chip=0.25, iters=2)
            assert r.value > 0, op
            assert r.bytes_moved > 0, op
            assert r.extra["devices"] == 8
        import pytest
        with pytest.raises(ValueError, match="unknown collective"):
            bench_collective("nope", mesh)
