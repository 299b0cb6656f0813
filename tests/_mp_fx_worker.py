"""Worker for the multi-PROCESS SPMD test (tests/test_distributed.py).

Each of N processes owns a disjoint set of devices (2 virtual CPU
devices here; the GPUs of a host in deployment); together they run ONE sharded
FX-correlator step over the global (2N)-device mesh through the exact
production entry points (`init_distributed` -> `make_sharded_fx_step`),
with cross-process collectives on the wire (gloo on CPU; NCCL on GPUs).
Each process verifies ITS OWN addressable output shards against the
float64 golden chain and prints PASS.

Usage: _mp_fx_worker.py <process_id> <num_processes> <coordinator_port>
       [mode]   mode = "fx" (default: all-to-all corner-turn + CMAC) or
                "sp" (time-sharded F-engine: overlap-save halo ppermute
                across the process boundary)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # workers run on the CPU backend

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> int:
    pid, n_proc, port = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    from dc_sand_tpu import golden
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.parallel.distributed import (init_distributed,
                                                  local_antenna_range)
    from dc_sand_tpu.models.fx import make_sharded_fx_step
    from dc_sand_tpu.utils import snr_db, np_c2ri
    from dc_sand_tpu.windows import pfb_window

    mode = sys.argv[4] if len(sys.argv) > 4 else "fx"
    info = init_distributed(coordinator=f"localhost:{port}",
                            num_processes=n_proc, process_id=pid)
    assert info["process_count"] == n_proc, info
    d = info["global_devices"]

    if mode == "runner":
        # FULL streaming FXRunner across processes: each host feeds its
        # LOCAL antennas' chunks; dumps all-gather at dump cadence
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner, DelayModel
        from dc_sand_tpu.utils import snr_db
        cfg = ChainConfig(name="mp", n_ants=8, n_pols=1, n_chans=128,
                          n_taps=4, spectra_per_chunk=8,
                          n_spectra_per_acc=16, run_xengine=True,
                          apply_delay=False, apply_requant=True)
        n_chunks = 4
        x = golden.quantize_adc(golden.gaussian_noise(
            (cfg.n_ants, 1, n_chunks * cfg.chunk_samples), 20.0, 21))
        a0, a1 = local_antenna_range(cfg.n_ants)
        mesh = build_mesh()
        r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                     mesh=mesh)
        dumps, counters = r.run(
            lambda i: x[a0:a1, :, i * cfg.chunk_samples:
                        (i + 1) * cfg.chunk_samples],
            n_chunks)
        assert counters.dumps == 2, counters
        lead = np.zeros((cfg.n_ants, 1, (cfg.n_taps - 1) * cfg.fft_size))
        spec_g = golden.f_engine(
            np.concatenate([lead, x], -1), pfb_window(cfg.n_taps,
                                                      cfg.fft_size),
            cfg.n_taps, cfg.n_chans,
            gains=np.full(cfg.n_chans, cfg.quant_scale) + 0j)
        for di, dump in enumerate(dumps):
            win = spec_g[:, :, di * 16:(di + 1) * 16]
            snr = snr_db(golden.xcorr(win),
                         dump.vis[..., 0] + 1j * dump.vis[..., 1])
            assert snr > 50, f"dump {di}: {snr:.1f} dB"
        print(f"PASS proc {pid}/{n_proc} (runner): {len(dumps)} dumps "
              f"> 50 dB through the streaming runner", flush=True)
        return 0

    if mode == "ckpt":
        # multi-process checkpoint/resume (VERDICT r2 #6): every
        # process saves its ADDRESSABLE shards mid-stream, a FRESH
        # runner restores them, and the resumed stream's dump is
        # BITWISE the uninterrupted one — with a drifting delay model
        # carried across the boundary on device (coarse_on_host=False)
        import tempfile
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import (FXRunner, DelayModel,
                                         save_state, load_state)
        cfg = ChainConfig(name="mpc", n_ants=8, n_pols=1, n_chans=128,
                          n_taps=4, spectra_per_chunk=8,
                          n_spectra_per_acc=16, run_xengine=True,
                          apply_delay=True, apply_requant=True)
        n_chunks = 4
        x = golden.quantize_adc(golden.gaussian_noise(
            (cfg.n_ants, 1, n_chunks * cfg.chunk_samples), 20.0, 55))
        a0, a1 = local_antenna_range(cfg.n_ants)
        mesh = build_mesh()
        w = pfb_window(cfg.n_taps, cfg.fft_size)

        def dm():
            m = DelayModel.zeros(cfg.n_ants, 1, max_delay=8)
            m.d0 = np.arange(cfg.n_ants, dtype=float).reshape(-1, 1) % 8
            m.p1 = np.full((cfg.n_ants, 1), 1e-7)
            return m

        def src(i):
            return x[a0:a1, :, i * cfg.chunk_samples:
                     (i + 1) * cfg.chunk_samples]

        kw = dict(mesh=mesh, coarse_on_host=False)
        straight = FXRunner(cfg, w, delay_model=dm(), **kw)
        dumps_ref, _ = straight.run(src, n_chunks)

        first = FXRunner(cfg, w, delay_model=dm(), **kw)
        dumps_a, _ = first.run(src, 2)
        ckpt = os.path.join(tempfile.gettempdir(),
                            f"mp_ckpt_{port}")     # per-run unique
        written = save_state(first, ckpt)
        assert f"proc{pid}of{n_proc}" in written, written

        resumed = FXRunner(cfg, w, delay_model=dm(), **kw)
        load_state(resumed, ckpt)
        assert resumed.chunk_idx == 2
        dumps_b, _ = resumed.run(src, 2)  # source gets ABSOLUTE idx
        os.unlink(written)

        assert len(dumps_ref) == 2 and len(dumps_a) == 1 \
            and len(dumps_b) == 1
        np.testing.assert_array_equal(dumps_a[0].vis, dumps_ref[0].vis)
        np.testing.assert_array_equal(dumps_b[0].vis, dumps_ref[1].vis)
        print(f"PASS proc {pid}/{n_proc} (ckpt): per-host shard "
              f"save/restore resumed bitwise (drifting delays carried)",
              flush=True)
        return 0

    if mode == "fengine":
        # F-engine-only streaming across processes (an F-host's
        # role): per-chunk spectra stay ANTENNA-SHARDED; each process
        # grades its own addressable shards vs golden
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.utils import snr_db, np_ri2c
        cfg = ChainConfig(name="mpf", n_ants=8, n_pols=2, n_chans=128,
                          n_taps=4, spectra_per_chunk=8,
                          apply_delay=False, apply_requant=True)
        n_chunks = 2
        x = golden.quantize_adc(golden.gaussian_noise(
            (8, 2, n_chunks * cfg.chunk_samples), 20.0, 66))
        a0, a1 = local_antenna_range(cfg.n_ants)
        mesh = build_mesh()
        outs = []
        r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                     mesh=mesh)
        r.run(lambda i: x[a0:a1, :, i * cfg.chunk_samples:
                          (i + 1) * cfg.chunk_samples],
              n_chunks, on_output=lambda i, o: outs.append(o))
        lead = np.zeros((8, 2, (cfg.n_taps - 1) * cfg.fft_size))
        spec_g = golden.f_engine(
            np.concatenate([lead, x], -1),
            pfb_window(cfg.n_taps, cfg.fft_size), cfg.n_taps,
            cfg.n_chans, gains=np.full(cfg.n_chans,
                                       cfg.quant_scale) + 0j)
        b = cfg.spectra_per_chunk
        checked = 0
        for ci, o in enumerate(outs):
            spectra = o["spectra"]         # (a, p, b, K, 2) wire array
            assert not spectra.is_fully_addressable  # really sharded
            for s in spectra.addressable_shards:
                idx = tuple(s.index)       # channel axis is unsharded
                ref = spec_g[idx[0], idx[1], ci * b:(ci + 1) * b, :]
                got = np.asarray(s.data)
                snr = snr_db(ref, np_ri2c(got))
                assert snr > 50, f"chunk {ci} shard {idx}: {snr:.1f}"
                checked += 1
        assert checked == n_chunks * len(
            outs[0]["spectra"].addressable_shards)
        print(f"PASS proc {pid}/{n_proc} (fengine): {checked} "
              f"antenna-sharded spectra shards > 50 dB", flush=True)
        return 0

    if mode.startswith("verify"):
        # the full verification harness itself, multi-process; an
        # optional ":config" suffix picks the preset — "verify:fx64" on
        # a 4-process x 4-device rig is the 16-device CONTRACT-mesh
        # rehearsal (BASELINE.json:5,10): 64 antennas sharded
        # 4-per-device over 16 devices, corner-turn + CMAC collectives
        # crossing 4 process boundaries
        from dc_sand_tpu.verify import verify_config, SNR_BOUND
        cfg_name = mode.split(":", 1)[1] if ":" in mode else "fx4"
        mesh = build_mesh()
        snrs, counters = verify_config(cfg_name, scale=128, mesh=mesh)
        assert snrs and all(v > SNR_BOUND for v in snrs.values()), snrs
        graded = ", ".join(f"{k} {v:.1f} dB" for k, v in snrs.items())
        print(f"PASS proc {pid}/{n_proc} (verify:{cfg_name}): {graded} "
              f"via verify_config over {d} global devices", flush=True)
        return 0

    if mode == "beam":
        # B-engine across processes: per-host partial beams psum over
        # the process boundary (the EP-analog collective); stokes
        # and incoherent ride along replicated
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.utils import snr_db, np_ri2c
        cfg = ChainConfig(name="mpb", n_ants=8, n_pols=2, n_chans=128,
                          n_taps=4, spectra_per_chunk=8, n_beams=3,
                          apply_delay=False, apply_requant=True,
                          incoherent_beam=True, beam_stokes=True)
        rng2 = np.random.default_rng(33)
        wts = rng2.normal(size=(3, 8, 128, 2)).astype(np.float32)
        n_chunks = 2
        x = golden.quantize_adc(golden.gaussian_noise(
            (8, 2, n_chunks * cfg.chunk_samples), 20.0, 34))
        a0, a1 = local_antenna_range(cfg.n_ants)
        mesh = build_mesh()
        outs = []
        r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                     weights=wts, mesh=mesh)
        r.run(lambda i: x[a0:a1, :, i * cfg.chunk_samples:
                          (i + 1) * cfg.chunk_samples],
              n_chunks, on_output=lambda i, o: outs.append(o))
        lead = np.zeros((8, 2, (cfg.n_taps - 1) * cfg.fft_size))
        spec_g = golden.f_engine(
            np.concatenate([lead, x], -1),
            pfb_window(cfg.n_taps, cfg.fft_size), cfg.n_taps,
            cfg.n_chans, gains=np.full(cfg.n_chans,
                                       cfg.quant_scale) + 0j)
        b = cfg.spectra_per_chunk
        wg = wts[..., 0] + 1j * wts[..., 1]
        beams_g = golden.beamform(spec_g[:, :, b:], wg)
        snr = snr_db(beams_g, np_ri2c(np.asarray(outs[1]["beams"])))
        assert snr > 50, f"beams: {snr:.1f} dB"
        snr_s = snr_db(golden.stokes(beams_g),
                       np.asarray(outs[1]["stokes"]))
        assert snr_s > 50, f"stokes: {snr_s:.1f} dB"
        print(f"PASS proc {pid}/{n_proc} (beam): beams {snr:.1f} dB, "
              f"stokes {snr_s:.1f} dB via cross-process psum",
              flush=True)
        return 0

    if mode == "beam_ep":
        # EP across processes: the partial-beam reduce-scatter
        # (psum_scatter over the beam axis) crosses the process
        # boundary, and each process ends holding ONLY its beam
        # subset — verified per addressable shard vs golden
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.utils import snr_db, np_ri2c
        cfg = ChainConfig(name="mpep", n_ants=8, n_pols=2, n_chans=128,
                          n_taps=4, spectra_per_chunk=8, n_beams=4,
                          apply_delay=False, apply_requant=True,
                          incoherent_beam=True, beam_stokes=True,
                          beam_parallel=True)
        rng2 = np.random.default_rng(43)
        wts = rng2.normal(size=(4, 8, 128, 2)).astype(np.float32)
        n_chunks = 2
        x = golden.quantize_adc(golden.gaussian_noise(
            (8, 2, n_chunks * cfg.chunk_samples), 20.0, 44))
        a0, a1 = local_antenna_range(cfg.n_ants)
        mesh = build_mesh()
        outs = []
        r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                     weights=wts, mesh=mesh)
        r.run(lambda i: x[a0:a1, :, i * cfg.chunk_samples:
                          (i + 1) * cfg.chunk_samples],
              n_chunks, on_output=lambda i, o: outs.append(o))
        lead = np.zeros((8, 2, (cfg.n_taps - 1) * cfg.fft_size))
        spec_g = golden.f_engine(
            np.concatenate([lead, x], -1),
            pfb_window(cfg.n_taps, cfg.fft_size), cfg.n_taps,
            cfg.n_chans, gains=np.full(cfg.n_chans,
                                       cfg.quant_scale) + 0j)
        b = cfg.spectra_per_chunk
        wg = wts[..., 0] + 1j * wts[..., 1]
        beams_g = golden.beamform(spec_g[:, :, b:], wg)
        stokes_g = golden.stokes(beams_g)
        shards = outs[1]["beams"].addressable_shards
        assert shards, "no addressable beam shards on this process"
        for s in shards:
            bsl = s.index[0]           # this shard's beam-axis slice
            assert s.data.shape[0] == cfg.n_beams // d
            snr = snr_db(beams_g[bsl], np_ri2c(np.asarray(s.data)))
            assert snr > 50, f"beam shard {bsl}: {snr:.1f} dB"
        for s in outs[1]["stokes"].addressable_shards:
            snr_s = snr_db(stokes_g[s.index[0]], np.asarray(s.data))
            assert snr_s > 50, f"stokes shard: {snr_s:.1f} dB"
        print(f"PASS proc {pid}/{n_proc} (beam_ep): local beam shards "
              f"verified vs golden via cross-process psum_scatter",
              flush=True)
        return 0

    if mode == "sp":
        # time-sharded F-engine: the overlap-save halo rides a ppermute
        # whose middle edge crosses the PROCESS boundary
        from dc_sand_tpu.models.fx import make_time_sharded_fengine
        from dc_sand_tpu.utils import snr_db, np_ri2c
        taps, n_chans = 4, 128
        m = 2 * n_chans
        frames = taps  # >= halo per shard
        x = golden.quantize_adc(golden.gaussian_noise(
            (2, 1, d * frames * m), 20.0, 9))
        mesh = build_mesh(time_shards=d)
        sh_t = NamedSharding(mesh, P(None, None, "time"))
        xg = jax.make_array_from_callback(x.shape, sh_t,
                                          lambda idx: x[idx])
        fe = make_time_sharded_fengine(mesh, pfb_window(taps, m), taps,
                                       n_chans)
        out = jax.block_until_ready(fe(xg))
        lead = np.zeros((2, 1, (taps - 1) * m))
        spec_g = golden.f_engine(np.concatenate([lead, x], -1),
                                 pfb_window(taps, m), taps, n_chans)
        checked = 0
        for s in out.addressable_shards:
            ref = spec_g[tuple(s.index)[:-1]]
            snr = snr_db(ref, np_ri2c(np.asarray(s.data)))
            assert snr > 50, f"shard {s.index}: {snr:.1f} dB"
            checked += 1
        assert checked == d // n_proc
        print(f"PASS proc {pid}/{n_proc} (sp): {checked} time shards "
              f"> 50 dB, halo crossed the process boundary", flush=True)
        return 0

    if mode == "sp_runner":
        # multi-process SP STREAMING runner (the one combination round 3
        # descoped): fx axis across processes (each host feeds its local
        # antennas' whole contiguous stream), time axis across each
        # host's LOCAL devices (build_mesh(time_local=True)) — and the
        # dumps are BITWISE the non-SP multi-process runner's (the time
        # regrouping of the int32 accumulation is exact)
        from dc_sand_tpu.config import ChainConfig
        from dc_sand_tpu.runtime import FXRunner
        from dc_sand_tpu.utils import snr_db
        base = dict(n_ants=8, n_pols=1, n_chans=128, n_taps=4,
                    spectra_per_chunk=8, n_spectra_per_acc=16,
                    run_xengine=True, apply_delay=False,
                    apply_requant=True)
        n_chunks = 4
        cfg0 = ChainConfig(name="mps0", **base)
        x = golden.quantize_adc(golden.gaussian_noise(
            (cfg0.n_ants, 1, n_chunks * cfg0.chunk_samples), 20.0, 33))
        a0, a1 = local_antenna_range(cfg0.n_ants)
        w = pfb_window(cfg0.n_taps, cfg0.fft_size)

        def src(i):
            return x[a0:a1, :, i * cfg0.chunk_samples:
                     (i + 1) * cfg0.chunk_samples]

        # reference: the plain antenna-sharded mp runner on all devices
        ref_runner = FXRunner(cfg0, w, mesh=build_mesh())
        dumps_ref, _ = ref_runner.run(src, n_chunks)

        tsh = d // n_proc   # time shards = each host's local devices
        cfg = ChainConfig(name="mps", **base).replace(time_shards=tsh)
        mesh = build_mesh(time_shards=tsh, time_local=True)
        assert mesh.shape["time"] == tsh
        r = FXRunner(cfg, w, mesh=mesh)
        dumps, counters = r.run(src, n_chunks)
        assert counters.dumps == len(dumps) == len(dumps_ref) == 2
        for dr, ds in zip(dumps_ref, dumps):
            np.testing.assert_array_equal(dr.vis, ds.vis)
        spec_g = golden.f_engine(
            np.concatenate([np.zeros((cfg.n_ants, 1,
                                      (cfg.n_taps - 1) * cfg.fft_size)),
                            x], -1), w, cfg.n_taps, cfg.n_chans,
            gains=np.full(cfg.n_chans, cfg.quant_scale) + 0j)
        for di, dump in enumerate(dumps):
            win = spec_g[:, :, di * 16:(di + 1) * 16]
            snr = snr_db(golden.xcorr(win),
                         dump.vis[..., 0] + 1j * dump.vis[..., 1])
            assert snr > 50, f"dump {di}: {snr:.1f} dB"
        print(f"PASS proc {pid}/{n_proc} (sp_runner): SP x fx streaming "
              f"runner bitwise vs the non-SP mp runner, > 50 dB vs "
              f"golden (time axis process-local)",
              flush=True)
        return 0

    n_ants, n_pols, taps, n_chans, nb = 8, 1, 4, 128, 8
    m = 2 * n_chans
    n = (nb + taps - 1) * m
    rng = np.random.default_rng(7)  # same seed everywhere: same sky
    x = golden.quantize_adc(golden.gaussian_noise((n_ants, n_pols, n),
                                                  20.0, 7))
    gains = np.full(n_chans, 0.05) + 0j
    fd = rng.uniform(-0.5, 0.5, (n_ants, n_pols, nb))
    ph = rng.uniform(-np.pi, np.pi, (n_ants, n_pols, nb))

    # each host would ingest only its local antennas (SURVEY.md §2.3
    # DP row); here every process holds the full array and hands jax
    # its addressable antenna shards
    a0, a1 = local_antenna_range(n_ants)
    assert (a1 - a0) * n_proc == n_ants

    mesh = build_mesh()  # all global devices on the fx axis
    sh_ant = NamedSharding(mesh, P("fx"))

    def shard_cb(index):
        return x[index]

    xg = jax.make_array_from_callback(x.shape, sh_ant, shard_cb)

    step = make_sharded_fx_step(mesh, pfb_window(taps, m), taps, n_chans,
                                n_ants)
    vis = step(xg, jnp.asarray(fd, jnp.float32),
               jnp.asarray(ph, jnp.float32), jnp.asarray(np_c2ri(gains)),
               jnp.zeros((n_ants, n_pols), jnp.int32))
    jax.block_until_ready(vis)

    # golden, on the full array (float64, host)
    spec_g = golden.f_engine(x, pfb_window(taps, m), taps, n_chans,
                             frac_delay=fd, phase=ph, gains=gains)
    vis_g = golden.xcorr(spec_g)

    # verify THIS process's addressable channel shards (out sharded on
    # axis 3 over all 2N devices — truly distributed output)
    checked = 0
    for s in vis.addressable_shards:
        got = np.asarray(s.data)
        ref = vis_g[tuple(s.index)[:-1]]   # golden is complex: no ri axis
        assert got.shape[:-1] == ref.shape, (got.shape, ref.shape)
        snr = snr_db(ref, got[..., 0] + 1j * got[..., 1])
        assert snr > 50, f"shard {s.index}: {snr:.1f} dB"
        checked += 1
    assert checked == d // n_proc, (checked, d, n_proc)
    print(f"PASS proc {pid}/{n_proc}: {checked} channel shards "
          f"> 50 dB over {d} global devices", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
