"""Command-line entry points (C20): run / verify / bench / info.

    python -m dc_sand_tpu.cli verify pfb1k
    python -m dc_sand_tpu.cli run fx4 --chunks 8
    python -m dc_sand_tpu.cli bench fengine
    python -m dc_sand_tpu.cli info
"""

from __future__ import annotations

import argparse
import logging
import sys


def _add_common(p):
    p.add_argument("--scale", type=int, default=None,
                   help="reduce n_chans for quick CPU checks")
    p.add_argument("--cpu", action="store_true",
                   help="pin computations to the CPU backend")
    p.add_argument("--mesh", type=int, default=0,
                   help="run the SPMD path over an N-device mesh")
    p.add_argument("--time-shards", type=int, default=1,
                   help="sequence-parallel: shard the sample stream "
                        "N ways over the mesh time axis (halo mode)")
    p.add_argument("--beam-parallel", action="store_true",
                   help="EP: shard beams over the mesh (psum_scatter "
                        "reduction; each device keeps its beam subset)")


def cmd_verify(args) -> int:
    from dc_sand_tpu.verify import (PRODUCTION_CADENCE, SNR_BOUND,
                                    verify_config)
    mesh = None
    if args.mesh or args.time_shards > 1:
        from dc_sand_tpu.parallel import build_mesh
        mesh = build_mesh(n_devices=args.mesh or args.time_shards,
                          time_shards=args.time_shards)
    kw = PRODUCTION_CADENCE if args.production_cadence else {}
    snrs, counters = verify_config(
        args.config, scale=args.scale, mesh=mesh,
        time_shards=args.time_shards,
        beam_parallel=args.beam_parallel, **kw)
    ok = all(v > SNR_BOUND for v in snrs.values())
    for stage, v in snrs.items():
        mark = "PASS" if v > SNR_BOUND else "FAIL"
        print(f"{args.config}:{stage}: {v:.1f} dB [{mark}]")
    if counters:
        print(f"  ({counters})")
    print(f"{args.config}: {'PASS' if ok else 'FAIL'} "
          f"(bound {SNR_BOUND} dB)")
    if args.record:
        # SNR regression record (SURVEY.md §4.2 regression row) through
        # the shared BenchResult writer: finish() stamps the device kind
        # so regress.py keys the series per device, and the scale shape
        # key keeps reduced runs out of the full-width series
        from dc_sand_tpu.bench.harness import BenchResult
        vname = args.config + ("_production" if args.production_cadence
                               else "")
        extra = dict(snrs)
        extra.update(time_shards=args.time_shards)
        if args.scale:
            extra["n_chans"] = args.scale
        path = BenchResult(
            name=f"verify_{vname}", metric="min stage SNR", unit="dB",
            value=min(snrs.values()), wall_s=0.0,
            extra=extra).finish().save()
        print(f"recorded {path}")
    return 0 if ok else 1


def cmd_run(args) -> int:
    import numpy as np
    from dc_sand_tpu import golden
    from dc_sand_tpu.config import get_config, scaled_for_test
    from dc_sand_tpu.runtime import FXRunner
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config(args.config)
    if args.scale:
        cfg = scaled_for_test(cfg, n_chans=args.scale)
    if args.time_shards > 1:
        cfg = cfg.replace(time_shards=args.time_shards)
    if args.beam_parallel:
        cfg = cfg.replace(beam_parallel=True)
    mesh = None
    if args.mesh or args.time_shards > 1:
        from dc_sand_tpu.parallel import build_mesh
        mesh = build_mesh(n_devices=args.mesh or args.time_shards,
                          time_shards=args.time_shards)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    rng = np.random.default_rng(0)
    weights = (rng.normal(size=(cfg.n_beams, cfg.n_ants, cfg.n_chans, 2))
               .astype(np.float32) if cfg.n_beams else None)
    runner = FXRunner(cfg, window, weights=weights, mesh=mesh)

    c = cfg.chunk_samples
    stream_chunks = {}

    def source(i):
        if i not in stream_chunks:
            stream_chunks[i] = golden.quantize_adc(
                golden.gaussian_noise((cfg.n_ants, cfg.n_pols, c), 20.0,
                                      seed=i))
        return stream_chunks[i]

    run_fn = runner.run_batched if args.batched else runner.run
    dumps, counters = run_fn(source, args.chunks,
                             drop_chunks=args.drop or ())
    print(f"config={cfg.name} hash={cfg.config_hash()} mode={runner.mode}")
    print(f"chunks={counters.chunks_in} dropped={counters.chunks_dropped} "
          f"samples_in={counters.samples_in} "
          f"spectra={counters.spectra_out} dumps={counters.dumps}")
    for i, d in enumerate(dumps):
        print(f"dump {i}: {d.n_spectra}/{d.n_spectra_nominal} spectra, "
              f"|V| mean {abs(d.vis.astype(float)).mean():.1f}")
    if args.checkpoint:
        from dc_sand_tpu.runtime import save_state
        saved = save_state(runner, args.checkpoint)
        print(f"state saved to {saved}")
    return 0


def cmd_bench(args) -> int:
    import contextlib
    import jax
    if jax.devices()[0].platform == "cpu" and not args.cpu:
        # a measurement that finds no accelerator fails; CPU runs are
        # harness validation only and must be asked for (--cpu)
        print("error: no accelerator found (use --cpu to validate the "
              "harness on the CPU backend)", file=sys.stderr)
        return 2
    ctx = contextlib.nullcontext()
    if args.profile:
        ctx = jax.profiler.trace(args.profile)
    with ctx:
        return _run_bench(args)


def _run_bench(args) -> int:
    results = []
    if args.target in ("fengine", "pfb"):
        from dc_sand_tpu.bench.pipelines import bench_fengine
        results.append(bench_fengine(full_chain=(args.target != "pfb"),
                                     n_chans=args.scale or 1024))
    elif args.target == "fx":
        from dc_sand_tpu.bench.pipelines import bench_fx_step
        kw = {"n_spectra": args.spectra} if args.spectra else {}
        results.append(bench_fx_step(n_chans=args.scale or 1024, **kw))
    elif args.target == "beam-step":
        from dc_sand_tpu.bench.pipelines import bench_beam_step
        kw = {"n_spectra": args.spectra} if args.spectra else {}
        results.append(bench_beam_step(n_chans=args.scale or 4096, **kw))
    elif args.target == "xcorr":
        from dc_sand_tpu.bench.kernels import bench_xcorr
        results.append(bench_xcorr(n_chans=args.scale or 4096))
        # the production cadence too — the chunk size the fx64 preset
        # dispatches (the accumulator read+write amortises with it)
        from dc_sand_tpu.config import get_config
        results.append(bench_xcorr(
            n_chans=args.scale or 4096,
            n_spectra=get_config("fx64").spectra_per_chunk))
    elif args.target == "beamform":
        from dc_sand_tpu.bench.kernels import bench_beamform
        results.append(bench_beamform(n_chans=args.scale or 4096))
        results.append(bench_beamform(n_chans=args.scale or 4096,
                                      quant_scale=0.25))
    elif args.target == "fft":
        from dc_sand_tpu.bench.kernels import bench_fft
        results.extend(bench_fft(n_chans=args.scale or 1024))
    elif args.target == "membench":
        from dc_sand_tpu.bench.membench import (bench_membench, bench_h2d,
                                                 PATTERNS)
        for pat in PATTERNS:
            results.append(bench_membench(pat))
        results.append(bench_h2d())
    elif args.target == "ingest":
        from dc_sand_tpu.bench.ingest_bench import (bench_ingest_host,
                                                    bench_ingest_runner,
                                                    bench_ingest_udp)
        results.append(bench_ingest_host(delay_in_ingest=True,
                                         zero_copy=True, n_workers=4))
        results.append(bench_ingest_host(delay_in_ingest=True,
                                         zero_copy=True))
        results.append(bench_ingest_host(delay_in_ingest=True))
        results.append(bench_ingest_host(delay_in_ingest=False))
        results.append(bench_ingest_udp())
        results.append(bench_ingest_udp(n_workers=4))
        results.append(bench_ingest_runner())
    elif args.target == "e2e":
        from dc_sand_tpu.bench.ingest_bench import bench_e2e_atrate
        results.append(bench_e2e_atrate(
            spectra=args.spectra or 2048,
            n_chans=args.scale or 4096))
        # device-replay pair: same chunk loop with the chunks
        # pre-staged in device memory, so host-to-device is out of the
        # timed path
        results.append(bench_e2e_atrate(
            spectra=args.spectra or 2048,
            n_chans=args.scale or 4096, feed="device_replay"))
    elif args.target == "scaling":
        from dc_sand_tpu.bench.scaling import bench_scaling
        results.extend(bench_scaling(max_devices=args.mesh or 8))
    elif args.target == "collectives":
        from dc_sand_tpu.bench.collectives import (bench_collective,
                                                   COLLECTIVES)
        from dc_sand_tpu.parallel import build_mesh
        mesh = build_mesh(n_devices=args.mesh or None)
        for op in COLLECTIVES:
            results.append(bench_collective(op, mesh))
    for res in results:
        print(res.to_json())
        res.save()
    return 0


def cmd_info(args) -> int:
    import jax
    from dc_sand_tpu.config import CONFIG_NAMES, get_config
    devs = jax.devices()
    print(f"platform: {devs[0].platform}; device: {devs[0].device_kind}; "
          f"count: {len(devs)}; jax {jax.__version__}")
    for n in CONFIG_NAMES:
        c = get_config(n)
        print(f"  {n}: ants={c.n_ants} pols={c.n_pols} chans={c.n_chans} "
              f"taps={c.n_taps} xengine={c.run_xengine} beams={c.n_beams} "
              f"hash={c.config_hash()}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(prog="dc_sand_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("verify", help="run a config vs the golden chain")
    pv.add_argument("config")
    pv.add_argument("--record", action="store_true",
                    help="write an SNR regression record under bench/results")
    pv.add_argument("--production-cadence", action="store_true",
                    help="run the config's real chunk/integration "
                         "cadence (golden compared on a baseline subset)")
    _add_common(pv)
    pv.set_defaults(fn=cmd_verify)

    pr = sub.add_parser("run", help="stream a config through the runner")
    pr.add_argument("config")
    pr.add_argument("--chunks", type=int, default=8)
    pr.add_argument("--drop", type=int, nargs="*",
                    help="fault-inject: drop these chunk indices")
    pr.add_argument("--checkpoint", help="save state npz at the end")
    pr.add_argument("--batched", action="store_true",
                    help="offline fast path: scan one dump window per "
                         "device dispatch (fx mode, dump-aligned "
                         "--chunks)")
    _add_common(pr)
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("bench", help="benchmark on the local device")
    pb.add_argument("target", nargs="?", default="fengine",
                    choices=["fengine", "pfb", "fx", "beam-step",
                             "xcorr", "beamform", "fft", "collectives",
                             "membench", "scaling", "ingest", "e2e"])
    pb.add_argument("--profile", metavar="DIR",
                    help="write a jax.profiler (xprof/perfetto) trace")
    pb.add_argument("--spectra", type=int, default=None,
                    help="spectra per chunk for the step benches "
                         "(fx/beam-step; bigger chunks amortise the "
                         "accumulator HBM traffic)")
    _add_common(pb)
    pb.set_defaults(fn=cmd_bench)

    pg = sub.add_parser("regress",
                        help="compare latest bench results vs previous")
    pg.set_defaults(fn=lambda a: __import__(
        "dc_sand_tpu.bench.regress", fromlist=["main"]).main())

    pi = sub.add_parser("info")
    pi.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if getattr(args, "cpu", False):
        import os
        need = max(getattr(args, "mesh", 0) or 1,
                   getattr(args, "time_shards", 1))
        if need > 1:
            # simulated mesh on one host: the device count must be
            # forced BEFORE backend init (tests/conftest.py does the
            # same for the suite)
            flags = os.environ.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    flags + " --xla_force_host_platform_device_count="
                    f"{need}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    from dc_sand_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
