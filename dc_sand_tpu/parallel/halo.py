"""Overlap-save halo exchange (C14): the context-parallel analog.

When the sample stream is sharded over a ``time`` mesh axis, device i's
first output spectrum needs the trailing ``(taps-1)*M`` samples of device
i-1's segment (BASELINE.json:5 "overlap-save FIR boundary samples
exchanged via halo collectives") — structurally identical to
ring-attention/context-parallel halo passing (SURVEY.md §5).  One
neighbour ``lax.ppermute`` per chunk.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["halo_exchange_left"]


def halo_exchange_left(x_local: jax.Array, halo_len: int,
                       axis_name: str) -> jax.Array:
    """Inside shard_map: prepend the left neighbour's trailing samples.

    ``x_local: (..., t_local)`` -> ``(..., halo_len + t_local)``.  Shard 0
    (the stream head) gets zeros — the cold-start FIR history, matching
    the golden chain's convention that the first ``taps-1`` frames of the
    whole stream are history.  One neighbour ``lax.ppermute``.
    """
    if x_local.shape[-1] < halo_len:
        raise ValueError(
            f"time shard holds {x_local.shape[-1]} samples < halo "
            f"{halo_len}; each shard needs at least (taps-1)*fft_size "
            "samples for overlap-save")
    n = jax.lax.axis_size(axis_name)
    tail = x_local[..., -halo_len:]
    # send my tail to my right neighbour (i -> i+1); shard 0 receives
    # from nobody and must see zeros.
    perm = [(i, i + 1) for i in range(n - 1)]
    halo = jax.lax.ppermute(tail, axis_name, perm)
    return jnp.concatenate([halo, x_local], axis=-1)
