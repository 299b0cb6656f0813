"""The user's entry points on the CPU backend: ``cli.main`` (run, verify,
info), the single-device compile check ``__graft_entry__.entry()`` and
the multi-device dry-run."""

import jax
import pytest

import __graft_entry__ as graft
from dc_sand_tpu import cli
from dc_sand_tpu.utils.cache import CACHE_ENV


@pytest.fixture(autouse=True)
def _cache_in_tmp(monkeypatch, tmp_path):
    # cli.main turns the compile cache on; keep the suite's process
    # configuration untouched (JAX already read the variable at import)
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))


@pytest.mark.parametrize("preset", ["pfb1k", "pfb4k", "fx4", "fx64",
                                    "beam64"])
def test_run_preset(preset, capsys):
    assert cli.main(["run", preset, "--cpu", "--scale", "64",
                     "--chunks", "2"]) == 0
    out = capsys.readouterr().out
    assert f"config={preset}" in out
    assert "chunks=2 dropped=0" in out


@pytest.mark.parametrize("preset", ["fx64", "beam64"])
def test_verify_on_a_four_device_mesh(preset, capsys):
    assert cli.main(["verify", preset, "--cpu", "--mesh", "4",
                     "--scale", "64"]) == 0
    out = capsys.readouterr().out
    assert f"{preset}: PASS" in out


def test_info_reports_the_platform(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"platform: {jax.devices()[0].platform}" in out
    assert "fx64: ants=64" in out


def test_entry_compiles():
    fn, args = graft.entry()
    hist, acc, _ = jax.jit(fn).lower(*args).compile().output_shardings
    assert hist is not None and acc is not None


def test_dryrun_multichip_runs(capsys):
    graft.dryrun_multichip(8)
    assert "compiled and ran" in capsys.readouterr().out
