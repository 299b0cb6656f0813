"""Sharding & collectives (C13-C15): mesh, corner-turn, halo exchange.

The parallelism model (SURVEY.md §2.3 table; BASELINE.json:5,10):

* ``fx`` mesh axis — the F-engine shards *antennas* over devices (the DP
  analog: zero communication until the corner-turn); after the
  corner-turn the X/B-engines shard *frequency channels* over the same
  devices (the TP analog).  The corner-turn itself is ``lax.all_to_all``
  — the structural twin of Ulysses' seq<->head reshard.
* Time-axis sharding (the SP/context-parallel analog) splits the sample
  stream over devices; the 16-tap FIR needs the trailing ``(taps-1)*M``
  samples from the left neighbour — an overlap-save halo exchange via
  ``lax.ppermute`` (ring-attention's halo twin).
* Multi-host: the same SPMD program via ``jax.distributed`` (C15).

On a GPU host XLA lowers these collectives to NCCL; the cards of one host
reach each other all to all, so the mesh follows the algorithm alone.
"""

from .mesh import build_mesh, FX_AXIS, TIME_AXIS  # noqa: F401
from .corner_turn import corner_turn_all_to_all  # noqa: F401
from .halo import halo_exchange_left  # noqa: F401
