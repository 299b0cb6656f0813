"""What the GPU bring-up relies on: the compile-cache placement, no
silent fallback to the CPU, the ``chip_smoke.py`` contract, and the
published-peaks table.  The ``gpu``-marked tests run the main path on a
card and skip on the CPU backend."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from dc_sand_tpu.bench.harness import BenchResult, peaks_for
from dc_sand_tpu.parallel import build_mesh
from dc_sand_tpu.utils import cache

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_variable_is_honoured(self, monkeypatch, tmp_path):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; nothing else is set
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_a_fixed_path_in_the_checkout(self, monkeypatch):
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = cache.enable_compile_cache()
            assert got == os.path.join(_ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            assert cache.enable_compile_cache() == got   # stable
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_path_is_ignored_by_git(self):
        with open(os.path.join(_ROOT, ".gitignore")) as f:
            lines = {ln.strip() for ln in f}
        rel = os.path.relpath(cache.DEFAULT_CACHE_DIR, _ROOT)
        assert rel + "/" in lines or rel in lines


class TestNoFallback:
    def test_build_mesh_raises_when_short_of_devices(self):
        have = len(jax.devices())
        with pytest.raises(ValueError, match="requested"):
            build_mesh(n_devices=have + 1)
        assert build_mesh(n_devices=have).devices.size == have

    def test_chip_smoke_fails_on_the_cpu(self, capsys, monkeypatch,
                                         tmp_path):
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
        assert chip_smoke.main([]) != 0
        out = capsys.readouterr().out
        assert '"ok"' not in out

    def test_contract_line_is_exact(self):
        line = chip_smoke.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
        assert line == ('{"ok": true, "device": {"platform": "gpu", '
                        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
        assert json.loads(line)["device"]["count"] == 1

    def test_devices_option_selects_the_phases(self):
        assert chip_smoke.select_phases(4) == ("sharded",)
        single = chip_smoke.select_phases(1)
        assert "sharded" not in single
        assert set(single) == {"presets", "production", "ingest"}
        with pytest.raises(ValueError):
            chip_smoke.select_phases(2)

    def test_bench_entry_fails_on_the_cpu(self):
        r = subprocess.run([sys.executable, os.path.join(_ROOT, "bench.py")],
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode != 0
        assert r.stdout.strip() == ""


class TestPeaks:
    def test_unknown_device_kind_is_an_error(self):
        with pytest.raises(KeyError, match="no published peaks"):
            peaks_for("Some Other Accelerator")
        with pytest.raises(KeyError):
            BenchResult(name="x", metric="m", value=1.0, unit="u",
                        wall_s=1.0).finish("Some Other Accelerator")

    def test_cpu_has_no_roofline(self):
        assert peaks_for("cpu") is None
        r = BenchResult(name="x", metric="m", value=1.0, unit="u",
                        wall_s=1.0, bytes_moved=1e9).finish("cpu")
        assert r.hbm_roofline_frac is None
        assert r.extra["achieved_gb_s"] == pytest.approx(1.0)


class TestHloReport:
    def test_counts_library_gemms_and_xla_dots(self):
        hlo = "\n".join([
            '  %g = s32[4,8,8]{2,1,0} custom-call(s8[4,8,16]{2,1,0} %a, '
            's8[4,8,16]{2,1,0} %b), custom_call_target="__cublas$gemm"',
            # operands named only: their types come from their definitions
            '  %f.1 = s8[4,8,16]{2,1,0} fusion(%p0), kind=kLoop',
            '  %c.2 = (s32[4,8,8]{2,1,0}, s8[0]{0}) custom-call(%f.1, '
            '%f.1), custom_call_target="__cublas$gemm"',
            '  %d = f32[8,8]{1,0} dot(f32[8,4]{1,0} %x, f32[4,8]{1,0} %y)',
        ])
        rep = chip_smoke.hlo_dot_report(hlo)
        assert rep["library_calls"] == {"__cublas$gemm(s8,s8->s32)": 2}
        assert rep["xla_dots"] == {"dot(f32,f32->f32)": 1}


@pytest.mark.gpu
class TestOnCard:
    def test_fx4_verifies_on_the_card(self, gpu_device):
        from dc_sand_tpu.verify import SNR_BOUND, verify_config
        snrs, _ = verify_config("fx4")
        assert snrs["visibilities"] > SNR_BOUND

    def test_int8_cmac_exact_on_the_card(self, gpu_device):
        from dc_sand_tpu import golden, ops
        rng = np.random.default_rng(5)
        q = rng.integers(-127, 128, (8, 64, 2, 256, 2), dtype=np.int8)
        acc = jax.numpy.zeros(ops.acc_shape(64, 2, 8), jax.numpy.int32)
        vis = np.asarray(ops.extract_vis(
            ops.xcorr_accumulate(acc, jax.device_put(q, gpu_device)),
            64, 2))
        ref = golden.xcorr((q[..., 0] + 1j * q[..., 1]).transpose(1, 2, 3, 0))
        np.testing.assert_array_equal(vis[..., 0], ref.real)
        np.testing.assert_array_equal(vis[..., 1], ref.imag)
