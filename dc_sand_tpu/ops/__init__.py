"""Compute ops for every pipeline stage, in plain ``jax.numpy``/``lax``.

Each op is the straightforward XLA form of its float64 golden model
(:mod:`dc_sand_tpu.golden`); XLA fuses the elementwise stages, sends
``rfft`` to the GPU's FFT library and the dots to its GEMM path.

Numerics policy (the >50 dB bound, BASELINE.json:5, drives everything):
int8 input -> float32 FIR accumulation -> float32 FFT and phase rotation ->
int8 requantised output -> int32-exact s8 x s8 -> s32 CMAC.  Every float32
dot carries ``precision=HIGHEST`` so TF32 never enters silently; bfloat16
does not appear on the signal path.
"""

from .pfb import pfb_fir  # noqa: F401
from .fft import channelize  # noqa: F401
from .phase import fine_delay_fringe  # noqa: F401
from .quant import requantize, dequantize  # noqa: F401
from .xcorr import (xcorr, xcorr_accumulate,  # noqa: F401
                    extract_vis, acc_shape)
from .beamform import beamform, incoherent_sum  # noqa: F401
from .stokes import stokes  # noqa: F401
