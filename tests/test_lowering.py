"""The full-width streaming steps, lowered with no data.

Each preset's ``make_step`` is lowered from ``ShapeDtypeStruct``s at its
published widths (fx64 at its own 2048-spectra chunk), so the program
the card compiles is checked here without allocating it: no Pallas or
other hand-written custom call, the output shapes and dtypes the runner
expects, and dot precision (every float32 dot at HIGHEST, so TF32 cannot
enter; every int8 dot accumulating in int32).  The sharded steps are
lowered over a 4-device CPU mesh and must carry the expected
collectives.
"""

import re

import jax
import jax.numpy as jnp
import pytest

from dc_sand_tpu.config import get_config
from dc_sand_tpu.models.pipeline import (history_len, make_step, mode_for,
                                         zero_vis_acc)
from dc_sand_tpu.parallel import build_mesh
from dc_sand_tpu.windows import pfb_window

PRESETS = ("pfb1k", "pfb4k", "fx4", "fx64", "beam64")
_CUSTOM = re.compile(r"custom_call|mosaic|triton|pallas",
                     re.IGNORECASE)


def _abstract_args(cfg):
    a, p, k, b = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.spectra_per_chunk
    sds = jax.ShapeDtypeStruct
    return (sds((a, p, history_len(cfg, 0)), jnp.int8),
            sds(jax.eval_shape(lambda: zero_vis_acc(cfg)).shape, jnp.int32),
            sds((a, p, cfg.chunk_samples), jnp.int8),
            sds((a, p), jnp.int32),
            sds((a, p, b), jnp.float32), sds((a, p, b), jnp.float32),
            sds((k, 2), jnp.float32),
            sds((max(cfg.n_beams, 1), a, k, 2), jnp.float32),
            sds((), jnp.bool_))


def _lower(cfg, mesh=None):
    step = make_step(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                     mesh=mesh)
    return step.lower(*_abstract_args(cfg))


_LOWERED = {}


def _lowered_preset(name):
    # one lowering per preset, shared by that preset's three checks
    if name not in _LOWERED:
        _LOWERED[name] = _lower(get_config(name))
    return _LOWERED[name]


def _expected_outputs(cfg):
    a, p, k, b = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.spectra_per_chunk
    mode = mode_for(cfg)
    if mode == "fengine":
        dt = jnp.int8 if cfg.apply_requant else jnp.float32
        return {"spectra": ((a, p, b, k, 2), dt)}
    if mode == "fx":
        return {}
    out = {"beams": ((cfg.n_beams, p, b, k, 2), jnp.float32)}
    if cfg.incoherent_beam:
        out["incoherent"] = ((p, b, k), jnp.float32)
    return out


@pytest.mark.parametrize("name", PRESETS)
def test_full_width_step_has_no_custom_kernel(name):
    text = _lowered_preset(name).as_text()
    assert not _CUSTOM.search(text), _CUSTOM.search(text).group(0)
    assert "stablehlo.fft" in text        # the rfft is XLA's own


@pytest.mark.parametrize("name", PRESETS)
def test_full_width_step_output_shapes(name):
    cfg = get_config(name)
    hist, acc, outs = _lowered_preset(name).out_info
    assert hist.shape == (cfg.n_ants, cfg.n_pols, history_len(cfg, 0))
    assert hist.dtype == jnp.int8
    if mode_for(cfg) == "fx":
        ap = cfg.n_ants * cfg.n_pols
        assert acc.shape == (cfg.n_chans, ap, ap) and acc.dtype == jnp.int32
    want = _expected_outputs(cfg)
    assert set(outs) == set(want)
    for key, (shape, dtype) in want.items():
        assert outs[key].shape == shape, key
        assert outs[key].dtype == dtype, key


@pytest.mark.parametrize("name", PRESETS)
def test_full_width_step_dot_precision(name):
    dots = [ln for ln in _lowered_preset(name).as_text().splitlines()
            if "stablehlo.dot_general" in ln]
    if mode_for(get_config(name)) == "fengine":
        assert not dots            # FIR, rfft and requant need no dot
    for ln in dots:
        sig = ln.rsplit(":", 1)[-1]
        if "xi8>" in sig:
            # int8 CMAC: both operands int8, result int32
            assert re.search(r"->\s*tensor<[^>]*xi32>", sig), ln
        else:
            assert "xf32>" in sig, ln
            assert "precision = [HIGHEST, HIGHEST]" in ln, ln


@pytest.mark.parametrize("name,beam_parallel,collective", [
    ("fx64", False, "stablehlo.all_to_all"),
    ("beam64", False, "stablehlo.all_reduce"),
    ("beam64", True, "stablehlo.reduce_scatter"),
])
def test_sharded_step_lowers_with_collectives(name, beam_parallel,
                                              collective):
    """The 4-device sharded step (the fx64 corner-turn, the beam64
    psum and its beam_parallel psum_scatter) at full width."""
    cfg = get_config(name)
    if beam_parallel:
        cfg = cfg.replace(beam_parallel=True)
    text = _lower(cfg, mesh=build_mesh(n_devices=4)).as_text()
    assert collective in text
    assert not _CUSTOM.search(text)
