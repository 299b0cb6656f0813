"""Corner-turn (C7): antenna-major -> channel-major all-to-all.

The reference world ships this over 40/100 GbE SPEAD multicast between F
and X hosts (SURVEY.md §2.1); here it is a single ``lax.all_to_all``
inside ``shard_map`` (BASELINE.json:5,10), which XLA hands to NCCL on a
GPU mesh.  Golden semantics: :func:`dc_sand_tpu.golden.chain.corner_turn`
(a pure transpose).
"""

from __future__ import annotations

import jax

__all__ = ["corner_turn_all_to_all"]


def corner_turn_all_to_all(q_local: jax.Array, axis_name: str) -> jax.Array:
    """Inside shard_map: re-shard quantised spectra ant-major -> chan-major.

    ``q_local: (ant_local, pol, b, k_full, 2)`` (this device's antennas,
    all channels) -> ``(ant_full, pol, b, k_local, 2)`` (all antennas,
    this device's channel block).  Channel blocks are contiguous: device
    i owns channels ``[i*k_full/D, (i+1)*k_full/D)``.
    """
    # split the channel axis (3) over devices, concatenate the antenna
    # axis (0): exactly the FX corner-turn.
    return jax.lax.all_to_all(q_local, axis_name, split_axis=3,
                              concat_axis=0, tiled=True)
