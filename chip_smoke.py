#!/usr/bin/env python
"""Prove the F/X/B chain on an NVIDIA GPU, through the normal entry points.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --devices 4   # four cards: the sharded phase only

Single-card phases:

1. device report — the card's name and power limit (``nvidia-smi``), the
   JAX version, ``XLA_FLAGS`` and the compile-cache directory;
2. all five presets at full width through ``verify_config`` (what
   ``python -m dc_sand_tpu.cli verify <preset>`` runs), every stage
   > 50 dB against the float64 golden chain;
3. fx64 at its production cadence (``cli verify fx64
   --production-cadence``): the step's ``memory_analysis()``, the s8 dot
   lowering, the median wall time of warm chunks (informational), and the
   SNR against the golden chain on a 12-antenna subset;
4. ingest on the card: the SPEAD loopback example (packets -> native
   ingest -> runner -> dump -> packets).

With ``--devices 4``: fx64 over a 4-device mesh (``shard_map`` step,
``all_to_all`` corner-turn) dumps bitwise what one card dumps for the
same stream, and beam64 over 4 devices (psum-replicated and
``beam_parallel``) passes > 50 dB.

The last line of standard output is one JSON object, printed only when
every phase passed:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Exits non-zero, with no such line, when JAX finds no GPU or a phase
fails.  Runs in one process, so one process holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import runpy
import statistics
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.abspath(__file__))
SINGLE_CARD_PHASES = ("presets", "production", "ingest")
MULTI_CARD_PHASES = ("sharded",)
PRESETS = ("pfb1k", "pfb4k", "fx4", "fx64", "beam64")


def contract_line(platform: str, kind: str, count: int) -> str:
    """The result line: the device exactly as JAX reports it."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind,
                                              "count": count}})


def select_phases(devices: int) -> tuple:
    """The phases one invocation runs: the sharded phase alone on four
    devices, every single-card phase otherwise."""
    if devices == 1:
        return SINGLE_CARD_PHASES
    if devices == 4:
        return MULTI_CARD_PHASES
    raise ValueError(f"--devices must be 1 or 4, got {devices}")


def _say(msg: str) -> None:
    print(msg, flush=True)


def _nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()


def _report_snrs(tag: str, snrs: dict) -> bool:
    from dc_sand_tpu.verify import SNR_BOUND
    ok = bool(snrs) and all(v > SNR_BOUND for v in snrs.values())
    for stage, v in snrs.items():
        _say(f"  {tag}:{stage}: {v:.2f} dB "
             f"[{'PASS' if v > SNR_BOUND else 'FAIL'}]")
    return ok


def phase_presets() -> bool:
    from dc_sand_tpu.verify import verify_config
    ok = True
    for name in PRESETS:
        t0 = time.perf_counter()
        snrs, _ = verify_config(name)
        ok &= _report_snrs(name, snrs)
        _say(f"  {name}: {time.perf_counter() - t0:.1f} s "
             "(compile + run + golden)")
    return ok


def hlo_dot_report(hlo: str) -> dict:
    """How XLA lowered the dots of an optimized HLO module: library GEMM
    calls by target and ``operands->result`` element types, and the dots
    left to XLA's own code generator."""
    defn = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\(?"
                      r"(pred|s8|s32|f32|bf16|f16|c64)\[")
    types = {}
    for line in hlo.splitlines():
        m = defn.match(line)
        if m:
            types[m.group(1)] = m.group(2)

    operand = re.compile(r"(?:\b(pred|s8|s32|f32|bf16|f16|c64)\[[^\]]*\]"
                         r"(?:\{[^}]*\})?\s+)?%([\w.\-]+)")

    def operand_types(args):
        return ",".join(t or types.get(n, "?")
                        for t, n in operand.findall(args))

    calls, dots = {}, {}
    for line in hlo.splitlines():
        m = re.search(r'custom_call_target="([^"]+)"', line)
        op = None
        if m and ("gemm" in m.group(1) or "matmul" in m.group(1)):
            op, kind, table = "custom-call(", m.group(1), calls
        elif re.search(r"=\s*\S+\s+dot\(", line):
            op, kind, table = " dot(", "dot", dots
        if op is None:
            continue
        d = defn.match(line)
        args = line.split(op, 1)[1].split(")")[0]
        key = f"{kind}({operand_types(args)}->{d.group(2) if d else '?'})"
        table[key] = table.get(key, 0) + 1
    return {"library_calls": calls, "xla_dots": dots}


def phase_production() -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.models.pipeline import (history_len, make_step,
                                             zero_vis_acc)
    from dc_sand_tpu.verify import PRODUCTION_CADENCE, verify_config
    from dc_sand_tpu.windows import pfb_window

    cfg = get_config("fx64")
    a, p, k, b = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.spectra_per_chunk
    _say(f"  fx64 cadence: {b}-spectra chunks, "
         f"{cfg.n_spectra_per_acc}-spectra dumps, chunk "
         f"{a * p * cfg.chunk_samples / 1e9:.2f} GB int8, accumulator "
         f"{k * (a * p) ** 2 * 4 / 1e6:.0f} MB int32")
    step = make_step(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window))
    sds = jax.ShapeDtypeStruct
    args = (sds((a, p, history_len(cfg, 0)), jnp.int8),
            sds(jax.eval_shape(lambda: zero_vis_acc(cfg)).shape, jnp.int32),
            sds((a, p, cfg.chunk_samples), jnp.int8),
            sds((a, p), jnp.int32), sds((a, p, b), jnp.float32),
            sds((a, p, b), jnp.float32), sds((k, 2), jnp.float32),
            sds((1, a, k, 2), jnp.float32), sds((), jnp.bool_))
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    _say(f"  step compile: {time.perf_counter() - t0:.1f} s")
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    sizes = {f: int(getattr(mem, f)) for f in fields}
    for f in fields:
        _say(f"  memory_analysis.{f}: {sizes[f]} "
             f"({sizes[f] / 2 ** 30:.2f} GiB)")
    need = (sizes["argument_size_in_bytes"] + sizes["output_size_in_bytes"]
            - sizes["alias_size_in_bytes"] + sizes["temp_size_in_bytes"])
    limit = jax.devices()[0].memory_stats().get("bytes_limit", 0)
    _say(f"  step needs {need / 2 ** 30:.2f} GiB of the "
         f"{limit / 2 ** 30:.2f} GiB JAX may use on the card")
    if limit and need > limit:
        _say("  FAIL: the fx64 production step does not fit the card")
        return False
    _say(f"  s8 dot lowering: {json.dumps(hlo_dot_report(compiled.as_text()))}")

    # informational: warm step walls on device-made data (not a benchmark)
    hist = jnp.zeros(args[0].shape, jnp.int8)
    acc = jnp.zeros(args[1].shape, jnp.int32)
    chunk = jax.jit(lambda: (jax.random.normal(
        jax.random.key(0), args[2].shape) * 20).astype(jnp.int8))()
    rest = (jnp.zeros((a, p), jnp.int32), jnp.zeros((a, p, b)),
            jnp.zeros((a, p, b)),
            jnp.asarray(np.stack([np.full(k, 0.05, np.float32),
                                  np.zeros(k, np.float32)], -1)),
            jnp.zeros((1, a, k, 2)), jnp.asarray(False))
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        hist, acc, _outs = compiled(hist, acc, chunk, *rest)
        jax.block_until_ready((hist, acc))
        walls.append(time.perf_counter() - t0)
    _say(f"  warm chunk wall, median of {len(walls) - 2}: "
         f"{statistics.median(walls[2:]) * 1e3:.2f} ms "
         f"(all: {', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; "
         "informational)")
    del hist, acc, chunk, rest, compiled

    t0 = time.perf_counter()
    snrs, counters = verify_config("fx64", **PRODUCTION_CADENCE)
    _say(f"  verify fx64 --production-cadence: "
         f"{time.perf_counter() - t0:.1f} s ({counters})")
    return _report_snrs("fx64-production", snrs)


def phase_ingest() -> bool:
    g = runpy.run_path(os.path.join(_ROOT, "examples", "spead_loopback.py"),
                       run_name="spead_loopback")
    return g["main"]() == 0


def phase_sharded() -> bool:
    import numpy as np

    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.golden.sources import gaussian_noise_int8
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.runtime import FXRunner
    from dc_sand_tpu.verify import verify_config
    from dc_sand_tpu.windows import pfb_window

    mesh = build_mesh(n_devices=4)
    ok = True
    # fx64 at full width: the 4-device dump == the 1-device dump, bitwise
    cfg = get_config("fx64").replace(spectra_per_chunk=256,
                                     n_spectra_per_acc=512)
    n_chunks = 2
    stream = gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, n_chunks * cfg.chunk_samples), 20.0, 3)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    gains = np.stack([np.full(cfg.n_chans, 0.05, np.float32),
                      np.zeros(cfg.n_chans, np.float32)], -1)

    def dumps(mesh_):
        r = FXRunner(cfg, window, gains=gains, mesh=mesh_)
        c = cfg.chunk_samples
        d, _ = r.run(lambda i: stream[..., i * c:(i + 1) * c], n_chunks)
        return d

    t0 = time.perf_counter()
    d4, d1 = dumps(mesh), dumps(None)
    same = (len(d4) == len(d1) == 1
            and np.array_equal(d4[0].vis, d1[0].vis)
            and bool(np.any(d1[0].vis)))
    _say(f"  fx64 4-device dump == 1-device dump (bitwise, "
         f"{d1[0].vis.shape} int32): {same} "
         f"({time.perf_counter() - t0:.1f} s)")
    ok &= same
    for tag, kw in (("fx64-mesh4", {}), ("beam64-mesh4-psum", {}),
                    ("beam64-mesh4-beam_parallel",
                     {"beam_parallel": True})):
        t0 = time.perf_counter()
        snrs, _ = verify_config(tag.split("-")[0], mesh=mesh, **kw)
        ok &= _report_snrs(tag, snrs)
        _say(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    return ok


_PHASES = {"presets": phase_presets, "production": phase_production,
           "ingest": phase_ingest, "sharded": phase_sharded}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="1 (default): every single-card phase; "
                         "4: the sharded phase only")
    args = ap.parse_args(argv)
    phases = select_phases(args.devices)

    sys.path.insert(0, _ROOT)
    import jax
    from dc_sand_tpu.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    if platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {len(devs)} "
              f"{platform} device(s) ({kind})", file=sys.stderr)
        return 1
    if len(devs) < args.devices:
        print(f"chip_smoke: --devices {args.devices} needs "
              f"{args.devices} GPUs; JAX found {len(devs)}",
              file=sys.stderr)
        return 1
    _say("== device report")
    _say(f"  nvidia-smi: {_nvidia_smi()}")
    _say(f"  jax {jax.__version__}; {len(devs)} x {kind} ({platform})")
    _say(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    _say(f"  XLA_PYTHON_CLIENT_MEM_FRACTION="
         f"{os.environ.get('XLA_PYTHON_CLIENT_MEM_FRACTION', '')!r}")
    _say(f"  compile cache: {cache_dir}")

    failed = []
    for name in phases:
        _say(f"== {name}")
        t0 = time.perf_counter()
        try:
            ok = _PHASES[name]()
        except Exception as e:  # a phase failure fails the run, reported
            import traceback
            traceback.print_exc()
            _say(f"  error: {type(e).__name__}: {e}")
            ok = False
        _say(f"== {name}: {'PASS' if ok else 'FAIL'} "
             f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            failed.append(name)
    _say(f"nvidia-smi: {_nvidia_smi()}")
    if failed:
        _say(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(contract_line(platform, kind, len(devs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
