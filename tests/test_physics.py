"""End-to-end physics: delay compensation actually stops the fringes.

The whole point of the F-engine's delay/phase machinery is that two
antennas seeing the same wavefront at different times produce aligned
streams after correction, so the cross-correlation phase is zero.  This
drives the REAL pipeline (runner, host coarse delay, fine-delay ramp,
requant, X-engine) with physically delayed inputs and checks the
visibility phases — not against the golden model, but against physics.
"""

import numpy as np
import pytest

from dc_sand_tpu import golden
from dc_sand_tpu.config import ChainConfig
from dc_sand_tpu.runtime import DelayModel, FXRunner
from dc_sand_tpu.windows import pfb_window

N_CHANS = 128
M = 2 * N_CHANS
TAPS = 8
FS = 1712e6


def _delayed_tone_streams(delays_samples, n_samples, k0, amp=90.0):
    """Antenna a receives the wavefront ADVANCED by its geometric delay
    (the F-engine will delay it back): x_a[t] = s(t + D_a)."""
    freq = k0 * FS / M
    t = np.arange(n_samples, dtype=np.float64)
    streams = [amp * np.cos(2 * np.pi * freq * (t + d) / FS)
               for d in delays_samples]
    return golden.quantize_adc(np.stack(streams)[:, None, :])


class TestFringeStopping:
    def _run(self, delays, compensate):
        n_ants = len(delays)
        cfg = ChainConfig(name="t", n_ants=n_ants, n_pols=1,
                          n_chans=N_CHANS, n_taps=TAPS,
                          spectra_per_chunk=8, n_spectra_per_acc=16,
                          apply_delay=True, apply_requant=True,
                          run_xengine=True, quant_scale=0.005)
        n_chunks = 2
        k0 = 37
        stream = _delayed_tone_streams(
            delays, n_chunks * cfg.chunk_samples, k0)
        dm = DelayModel.zeros(n_ants, 1, max_delay=16)
        if compensate:
            dm.d0 = np.asarray(delays, float).reshape(n_ants, 1)
        runner = FXRunner(cfg, pfb_window(TAPS, M), delay_model=dm)
        dumps, _ = runner.run(
            lambda i: stream[..., i * cfg.chunk_samples:
                             (i + 1) * cfg.chunk_samples], n_chunks)
        vis = dumps[0].vis
        v01 = vis[1, 0, 0, k0, 0] + 1j * vis[1, 0, 0, k0, 1]  # bl (0,1)
        return v01, k0

    def test_integer_delay_compensated_phase_is_zero(self):
        v01, _ = self._run([3, 11], compensate=True)
        assert abs(v01) > 0
        assert abs(np.angle(v01)) < 0.02  # fringe stopped

    def test_fractional_delay_compensated(self):
        """Non-integer geometric delay: coarse rounds, the fine-delay
        phase ramp absorbs the residual."""
        v01, _ = self._run([2.37, 9.81], compensate=True)
        assert abs(v01) > 0
        assert abs(np.angle(v01)) < 0.03

    def test_uncompensated_phase_matches_geometry(self):
        delays = [0, 7]
        v01, k0 = self._run(delays, compensate=False)
        # x0[t]=s(t), x1[t]=s(t+7): V = <x0 conj(x1)> has phase
        # -2*pi*f*7/fs = -2*pi*k0*7/M (mod 2pi)
        expect = -2 * np.pi * k0 * delays[1] / M
        diff = np.angle(v01) - expect
        diff = (diff + np.pi) % (2 * np.pi) - np.pi
        assert abs(diff) < 0.08

    def test_incoherent_when_uncompensated_coherent_when_fixed(self):
        """Half-channel offset tone: with a CONSTANT delay both runs
        keep full correlation amplitude (decorrelation needs a drifting
        phase within the window) — what compensation fixes is the
        PHASE.  Assert both: amplitude persists through compensation
        (a fine-delay regression that decorrelates the tone would
        collapse |v_c| and make the angle noise), and the phase is
        stopped only in the compensated run."""
        v_c, _ = self._run([0.5, 10.5], compensate=True)
        v_u, _ = self._run([0.5, 10.5], compensate=False)
        assert abs(v_c) > 0.5 * abs(v_u) > 0
        assert abs(np.angle(v_c)) < 0.05
        assert abs(np.angle(v_u)) > 0.2
