"""Typed configuration for the F/X signal chain (C19 in SURVEY.md §2.3).

The five canned presets correspond one-to-one to the graded evaluation
configs in BASELINE.json:7-11; ``get_config(name)`` returns them.  Every
field is static (shapes are compile-time constants for XLA).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

__all__ = [
    "ChainConfig",
    "get_config",
    "CONFIG_NAMES",
    "scaled_for_test",
]


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static parameters of one F/X pipeline instance.

    Shapes and rates
    ----------------
    n_ants, n_pols:
        Antennas and polarisations per antenna.  The MeerKAT-style target is
        64 ants x 2 pols (BASELINE.json:5).
    n_chans:
        Output frequency channels.  Real->complex channelizer: FFT length is
        ``2 * n_chans`` and each output spectrum consumes ``2 * n_chans`` new
        real samples (critically sampled).
    n_taps:
        Polyphase FIR taps (contract: 16, BASELINE.json:5).
    window:
        Prototype window kind, see :func:`dc_sand_tpu.windows.pfb_window`.
    sample_rate_hz:
        ADC real-sample rate.  856 MHz bandwidth => 1712 Msps (Nyquist),
        BASELINE.json:5.

    Stages
    ------
    apply_delay / apply_requant:
        Config 1 (BASELINE.json:7) runs the bare PFB; configs 2+ add coarse
        delay + fringe rotation and 8-bit requantisation (BASELINE.json:8).
    n_spectra_per_acc:
        X-engine integration length in spectra per accumulator dump
        (BASELINE.json:9).
    n_beams:
        Coherent beams formed by the B-engine (0 = no beamformer;
        BASELINE.json:11).

    Streaming / sharding
    --------------------
    spectra_per_chunk:
        Spectra processed per jitted streaming step (C21).
    shard_ants / shard_chans:
        Mesh-axis mapping: F-engine shards antennas, X/B-engine shards
        channels after the corner-turn (BASELINE.json:5,10).
    """

    name: str
    n_ants: int = 1
    n_pols: int = 1
    n_chans: int = 1024
    n_taps: int = 16
    window: str = "hann-sinc"
    sample_rate_hz: float = 1712e6

    # Stage toggles.
    apply_delay: bool = False
    apply_requant: bool = False
    run_xengine: bool = False
    n_beams: int = 0
    incoherent_beam: bool = False
    # Stokes I/Q/U/V detection on the (float) beam voltages before any
    # int8 beam quantisation — the B-engine's standard downstream
    # product (ops/stokes.py).  Needs dual-pol beams.  ``None`` (= off)
    # rather than False so enabling the knob later never invalidates
    # existing config hashes (config_hash drops None fields).
    beam_stokes: bool = None
    # 8-bit beam output (C10's "int8 output"): scale applied before
    # round/saturate; 0.0 keeps float32 beams
    beam_quant_scale: float = 0.0

    # Integration / streaming.
    n_spectra_per_acc: int = 64
    spectra_per_chunk: int = 64

    # Quantisation.
    quant_scale: float = 1.0  # default per-channel EQ gain magnitude

    # Sharding intent (used by models/parallel when a mesh is supplied).
    shard_ants: bool = False
    shard_chans: bool = False
    # Sequence-parallel (SP) streaming: >1 shards the sample stream over
    # the mesh's time axis with per-chunk overlap-save halo exchange and
    # a carried cross-chunk FIR history (no cold start except chunk 0).
    # First-class for the F-engine modes; FX/beam shard antennas/channels
    # on the fx axis instead (SURVEY.md §2.3 parallelism table).
    time_shards: int = 1
    # Beam-parallel B-engine (the EP analog, SURVEY.md §2.3 parallelism
    # table): instead of psum-replicating every beam on every chip, the
    # partial-beam reduction over antenna shards runs as a
    # ``psum_scatter`` over the beam axis, so each device keeps a
    # fully-reduced 1/N beam subset — half the link traffic of the
    # all-reduce and the downstream Stokes/requant work sharded N ways.
    # Needs n_beams divisible by the fx-axis size.  ``None`` (= off)
    # rather than False so enabling the knob's *existence* does not
    # invalidate existing config hashes (config_hash drops None fields).
    beam_parallel: bool = None

    # ------------------------------------------------------------------
    @property
    def fft_size(self) -> int:
        """Real-FFT length M = 2 * n_chans."""
        return 2 * self.n_chans

    @property
    def window_len(self) -> int:
        return self.n_taps * self.fft_size

    @property
    def history_len(self) -> int:
        """Carried FIR history (overlap-save): (taps-1) * M samples."""
        return (self.n_taps - 1) * self.fft_size

    @property
    def n_baselines(self) -> int:
        """Antenna pairs i<=j including autos: N(N+1)/2 (2080 at 64 ants)."""
        return self.n_ants * (self.n_ants + 1) // 2

    @property
    def chunk_samples(self) -> int:
        """New real samples consumed per streaming chunk, per ant/pol."""
        return self.spectra_per_chunk * self.fft_size

    def config_hash(self) -> str:
        """Stable short hash for bench-result provenance (BASELINE.md §40+).

        ``None``-valued fields are dropped before hashing so adding an
        optional knob (default ``None`` = previous behaviour) does not
        invalidate every existing checkpoint/record hash."""
        payload = json.dumps(
            {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None}, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def replace(self, **kw) -> "ChainConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# The five graded evaluation configs, BASELINE.json:7-11.
# ----------------------------------------------------------------------

_CONFIGS = {
    # 1. "Single-pol 1k-channel PFB (16-tap Hann FIR + 2048-pt FFT) on
    #    synthetic CW-tone stream, NumPy-checkable on CPU"  [BASELINE.json:7]
    "pfb1k": ChainConfig(
        name="pfb1k",
        n_ants=1,
        n_pols=1,
        n_chans=1024,
        window="hann",
    ),
    # 2. "Dual-pol 4k-channel PFB with coarse delay + fringe rotation and
    #    8-bit requantization"  [BASELINE.json:8]
    "pfb4k": ChainConfig(
        name="pfb4k",
        n_ants=1,
        n_pols=2,
        n_chans=4096,
        apply_delay=True,
        apply_requant=True,
    ),
    # 3. "4-antenna FX correlator: PFB F-engine -> corner-turn -> X-engine
    #    visibilities with accumulation"  [BASELINE.json:9]
    "fx4": ChainConfig(
        name="fx4",
        n_ants=4,
        n_pols=2,
        n_chans=1024,
        apply_delay=True,
        apply_requant=True,
        run_xengine=True,
    ),
    # 4. "64-antenna dual-pol FX correlator, channels sharded across chips,
    #    all-to-all corner-turn"  [BASELINE.json:10]  (chips = devices)
    "fx64": ChainConfig(
        name="fx64",
        n_ants=64,
        n_pols=2,
        n_chans=4096,
        apply_delay=True,
        apply_requant=True,
        run_xengine=True,
        shard_ants=True,
        shard_chans=True,
        # Production cadence: the X-engine reads and writes the whole
        # (4096, 128, 128) int32 accumulator (268 MB) once per chunk,
        # so longer chunks amortise it.  One 2048-spectra chunk is
        # 9.8 ms of stream and 2.15 GB of int8 input; a dump every 4
        # chunks (8192 spectra, 39 ms).  The cadence is carried over
        # from the earlier accelerator and has not been re-tuned for
        # the GPU (ROADMAP A5).
        spectra_per_chunk=2048,
        n_spectra_per_acc=8192,
    ),
    # 5. "Coherent beamformer (multi-beam weighted sum) + incoherent sum
    #    fused with the 64-antenna F-engine"  [BASELINE.json:11]
    "beam64": ChainConfig(
        name="beam64",
        n_ants=64,
        n_pols=2,
        n_chans=4096,
        apply_delay=True,
        apply_requant=True,
        n_beams=16,
        incoherent_beam=True,
        shard_ants=True,
        shard_chans=True,
        spectra_per_chunk=256,
    ),
}

CONFIG_NAMES = tuple(_CONFIGS)


def get_config(name: str) -> ChainConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"unknown config {name!r}; available: {', '.join(CONFIG_NAMES)}"
        ) from None


def scaled_for_test(cfg: ChainConfig, *, n_chans: Optional[int] = None,
                    spectra_per_chunk: int = 8) -> ChainConfig:
    """Shrink a preset to CI-friendly shapes, preserving its stage toggles.

    Used by tests and the multichip dry-run so full-chain semantics are
    exercised without full-scale buffers.
    """
    kw = {"spectra_per_chunk": spectra_per_chunk,
          "n_spectra_per_acc": spectra_per_chunk}
    if n_chans is not None:
        kw["n_chans"] = n_chans
    return cfg.replace(**kw)
