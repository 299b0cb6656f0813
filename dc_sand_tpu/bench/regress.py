"""Benchmark regression tracking (SURVEY.md §4.2 "Regression" row).

``python -m dc_sand_tpu.bench.regress`` compares the newest result of
each benchmark under ``bench/results/`` against the previous one and
flags drops beyond tolerance.  Results files are written per run by
``BenchResult.save`` keyed by commit + timestamp.

Comparisons are keyed on ``(name, device kind, shape)``: a CPU-mesh
harness validation run must never gate — or be gated by — accelerator
numbers, nor one accelerator another's, and a benchmark re-run at a different problem shape (channel
count, spectra tile, worker count, ...) starts its own series instead
of reading as a spurious regression against the old shape.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
from collections import defaultdict

TOLERANCE = 0.10  # flag >10% throughput drop

# --- verify-record staleness gate ------------------------------------
#
# Rounds 2-4 each shipped kernel rewrites whose on-chip verify records
# were never refreshed (the >50 dB contract claim then rested on
# records of code that no longer existed).  This makes the check
# mechanical: for every judged config, the NEWEST verify record's
# commit must postdate every commit touching the verified compute path.
# ``cli regress`` fails red until ``cli verify <config> --record`` is
# re-run for the stale series.

# series that must exist and be fresh (filename prefix under results/)
VERIFY_SERIES = ("verify_pfb1k", "verify_pfb4k", "verify_fx4",
                 "verify_fx64", "verify_fx64_production", "verify_beam64")

# paths whose commits invalidate verify records: the kernels, the
# pipeline/step composition, the golden oracle, and the config presets
# (a preset cadence flip changes what "production cadence" verifies)
KERNEL_PATHS = ("dc_sand_tpu/ops", "dc_sand_tpu/models",
                "dc_sand_tpu/golden", "dc_sand_tpu/config.py",
                "dc_sand_tpu/verify.py")


def _git(args, repo_root):
    try:
        r = subprocess.run(["git", *args], capture_output=True, text=True,
                           timeout=15, cwd=repo_root)
        return r.returncode, r.stdout.strip()
    except Exception as e:  # git missing / timeout: report, don't crash
        return 1, str(e)


def verify_staleness(results_dir: str = "bench/results",
                     repo_root: str | None = None,
                     head: str = "HEAD") -> list:
    """Failure messages, one per missing/stale verify series ([] = fresh).

    A series is stale when any commit in ``rec_commit..head`` touches
    ``KERNEL_PATHS``; missing when no record or an unknown commit.
    """
    repo_root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    failures = []
    for series in VERIFY_SERIES:
        recs = []
        for path in glob.glob(os.path.join(results_dir, series + "_*.json")):
            stem = os.path.basename(path)[len(series) + 1:-len(".json")]
            parts = stem.split("_")
            if len(parts) != 2 or not parts[1].isdigit():
                continue  # a longer series name sharing the prefix
            recs.append((int(parts[1]), parts[0]))
        if not recs:
            failures.append(f"{series}: NO verify record at all")
            continue
        _, commit = max(recs)
        rc, _ = _git(["cat-file", "-e", commit + "^{commit}"], repo_root)
        if rc != 0:
            failures.append(f"{series}: record commit {commit} unknown "
                            "to this repo")
            continue
        rc, out = _git(["log", "--format=%h %s", f"{commit}..{head}",
                        "--", *KERNEL_PATHS], repo_root)
        if rc != 0:
            failures.append(f"{series}: git log failed: {out}")
        elif out:
            touching = out.splitlines()
            failures.append(
                f"{series}: newest record is at {commit} but "
                f"{len(touching)} kernel-path commit(s) postdate it "
                f"(newest: {touching[0]}) — rerun `cli verify "
                f"<config> --record`")
    return failures

# extra-dict keys that define the measured problem's SHAPE: same-name
# records differing in any of these are different experiments
_SHAPE_KEYS = ("n_chans", "n_spectra", "n_ants", "n_streams", "n_beams",
               "n_workers", "spectra", "taps", "mode", "layout",
               "delay_in_ingest", "packet_samples")


def _platform_of(rec: dict) -> str:
    extra = rec.get("extra") or {}
    return str(extra.get("device_kind") or extra.get("platform")
               or extra.get("chip") or "unknown")


def _shape_of(rec: dict) -> str:
    extra = rec.get("extra") or {}
    parts = [f"{k}={extra[k]}" for k in _SHAPE_KEYS if k in extra]
    return ",".join(parts)


def implausible(rec: dict) -> str:
    """Reason a record is self-evidently invalid, or '' if it's sane.

    Round 3 shipped a scaling record whose 1-dev wall had a compile
    stall leaked into it, making the 2-dev row report efficiency 520x —
    garbage that then poisons every later comparison in its series.
    Weak-scaling efficiency is bounded by ~1 (a super-unitary value
    means the baseline, not this run, is wrong)."""
    extra = rec.get("extra") or {}
    eff = extra.get("efficiency_vs_1dev")
    if eff is not None and eff > 1.2:
        return f"efficiency_vs_1dev={eff:.3g} > 1.2"
    if rec.get("value", 0) < 0 or rec.get("wall_s", 0) < 0:
        return "negative value/wall"
    return ""


def load_results(results_dir: str = "bench/results"):
    by_key = defaultdict(list)
    rejected = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        try:
            with open(path) as f:
                rec = json.loads(f.readline())
            ts = int(path.rsplit("_", 1)[1].split(".")[0])
            why = implausible(rec)
            if why:
                rejected.append((path, why))
                continue
            by_key[(rec["name"], _platform_of(rec),
                    _shape_of(rec))].append((ts, rec, path))
        except (ValueError, KeyError, IndexError):
            continue
    for key in by_key:
        by_key[key].sort(key=lambda t: t[0])
    return by_key, rejected


def main(results_dir: str = "bench/results",
         check_verify: bool | None = None) -> int:
    by_key, rejected = load_results(results_dir)
    for path, why in rejected:
        print(f"REJECTED {os.path.basename(path)}: {why}")
    if not by_key:
        print(f"no results under {results_dir}")
        return 0
    failed = False
    if check_verify is None:
        # the staleness gate applies to the repo's canonical record set,
        # not to ad-hoc dirs handed in by tests
        check_verify = os.path.normpath(results_dir) == \
            os.path.normpath("bench/results")
    if check_verify:
        for msg in verify_staleness(results_dir):
            print(f"STALE-VERIFY {msg}")
            failed = True
    for (name, platform, shape), runs in sorted(by_key.items()):
        _, latest, _ = runs[-1]
        label = f"{name} [{platform}]" + (f" ({shape})" if shape else "")
        if len(runs) < 2:
            print(f"{label}: {latest['value']:.4g} {latest['unit']} "
                  "(first recording)")
            continue
        _, prev, _ = runs[-2]
        if prev["value"]:
            ratio = latest["value"] / prev["value"]
        else:
            # a zero previous value has no meaningful ratio: 0 -> 0 is
            # unchanged, 0 -> nonzero is an improvement, never a
            # regression (e.g. collective wire bytes on a 1-device mesh)
            ratio = 1.0 if not latest["value"] else float("inf")
        mark = "OK"
        if ratio < 1 - TOLERANCE:
            mark = "REGRESSION"
            failed = True
        elif ratio > 1 + TOLERANCE:
            mark = "improved"
        print(f"{label}: {latest['value']:.4g} {latest['unit']} "
              f"({ratio - 1:+.1%} vs prev) [{mark}]")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
