"""The verification driver itself (C16): every preset passes at reduced
scale on CPU, including config 4's sharded mode over the virtual mesh —
the same entry the CLI and the judge use."""

import numpy as np
import pytest

from dc_sand_tpu.verify import verify_config, SNR_BOUND
from dc_sand_tpu.parallel import build_mesh


@pytest.mark.parametrize("name", ["pfb1k", "pfb4k", "fx4"])
def test_configs_pass_scaled(name):
    snrs, _ = verify_config(name, scale=128)
    assert snrs and all(v > SNR_BOUND for v in snrs.values()), snrs


def test_fx64_sharded_mesh_passes():
    mesh = build_mesh(n_devices=4)
    snrs, _ = verify_config("fx64", scale=128, mesh=mesh)
    assert snrs["visibilities"] > SNR_BOUND


def test_beam64_passes_scaled():
    snrs, _ = verify_config("beam64", scale=128)
    assert snrs["beams"] > SNR_BOUND
    assert snrs["incoherent"] > SNR_BOUND


def test_golden_ants_subset_passes_and_matches_full():
    """The memory-bounded production-cadence oracle (golden_ants:
    per-antenna float64 evaluation, grading all pairs among an antenna
    subset) passes the bound and agrees with the full-chain grading on
    the same config/seed (both grade the identical device output, so a
    subset selection bug would show as a large SNR gap or an indexing
    crash)."""
    snrs_sub, _ = verify_config("fx64", scale=128,
                                golden_ants=5)
    assert snrs_sub["visibilities"] > SNR_BOUND, snrs_sub
    snrs_full, _ = verify_config("fx64", scale=128)
    assert snrs_full["visibilities"] > SNR_BOUND
    # one-sided guard: the subset samples the same error population so
    # its SNR may exceed the full grading's (even inf when the sampled
    # baselines carry zero post-requant LSB flips at this small scale),
    # but a mis-mapped baseline/antenna index would crater it
    assert snrs_sub["visibilities"] > snrs_full["visibilities"] - 20


def test_golden_ants_guards():
    with pytest.raises(ValueError, match="mutually exclusive"):
        verify_config("fx64", scale=128, golden_ants=4,
                      baseline_subset=8)
    with pytest.raises(ValueError, match="fx-mode"):
        verify_config("pfb1k", scale=128, golden_ants=4)


def test_misaligned_cadence_rejected():
    """The golden oracle slices exact integration windows while the
    runner dumps at chunk boundaries — a misaligned cadence must raise,
    not report a silently wrong SNR."""
    with pytest.raises(ValueError, match="multiple of spectra_per_chunk"):
        verify_config("fx4", scale=128,
                      spectra_per_chunk=3, n_spectra_per_acc=None)
