"""Checkpoint / resume (SURVEY.md §5): the streaming state is tiny —
delay polynomials, gains, beam weights, FIR-history tail, partial
accumulators, stream position — saved as npz at any chunk boundary;
resume = reload + continue the chunk loop.

The delay/weight state is part of the carry on purpose: a resume with a
*drifting* delay model (d1 != 0) must keep drifting from where it left
off, not silently re-zero the polynomials — the golden-equivalence test
drives exactly that case across a save/load boundary.

Multi-process runners checkpoint PER HOST: each process saves its
ADDRESSABLE shards of the sharded carries (history, the visibility
accumulator, beam weights) into its own ``{path}.proc{i}of{n}.npz``,
keyed by shard index; restore reassembles the global arrays with
``jax.make_array_from_callback`` (which asks each process only for its
own addressable shards).  No cross-host gather on either side — the
save is as distributed as the run.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["save_state", "load_state"]

# carries/parameters that live as sharded global arrays under a
# multi-process mesh (runner._put_full); everything else in a
# checkpoint is host-local/replicated state
_SHARDED_MP = ("history", "vis_acc", "weights")


def _proc_path(path: str) -> str:
    import jax
    return (path[:-len(".npz")]
            + f".proc{jax.process_index()}of{jax.process_count()}.npz")


def _pack_shards(out: dict, name: str, arr) -> None:
    """Addressable shards of a global array -> npz entries keyed by
    shard slot, each with its global index box (start/stop per dim)."""
    for j, s in enumerate(arr.addressable_shards):
        box = np.array(
            [[d.start if d.start is not None else 0,
              d.stop if d.stop is not None else dim]
             for d, dim in zip(s.index, arr.shape)], np.int64)
        out[f"{name}_shard{j}"] = np.asarray(s.data)
        out[f"{name}_idx{j}"] = box


def _unpack_shards(z, name: str, like):
    """Rebuild a global array with ``like``'s sharding from this
    process's saved shards (make_array_from_callback requests only the
    addressable shards, which are exactly what this process saved)."""
    import jax
    shards = {}
    j = 0
    while f"{name}_shard{j}" in z.files:
        box = z[f"{name}_idx{j}"]
        key = tuple((int(lo), int(hi)) for lo, hi in box)
        shards[key] = z[f"{name}_shard{j}"]
        j += 1
    if not shards:
        raise ValueError(f"checkpoint is missing shards for '{name}'")

    def cb(index):
        key = tuple((d.start if d.start is not None else 0,
                     d.stop if d.stop is not None else dim)
                    for d, dim in zip(index, like.shape))
        if key not in shards:
            raise ValueError(
                f"checkpoint shard layout mismatch for '{name}': this "
                f"process needs slice {key} but saved "
                f"{sorted(shards)} — resume with the same process "
                "count and mesh shape as the save")
        return shards[key]

    return jax.make_array_from_callback(like.shape, like.sharding, cb)


def save_state(runner, path: str) -> str:
    """Save the runner's carry; returns the ACTUAL file path written
    (np.savez appends '.npz' to an extensionless path — callers must
    report/reload the returned name, not the argument).  Multi-process
    runners write one file per process (``{path}.proc{i}of{n}.npz``) —
    call from EVERY process; the returned path is this process's."""
    import jax
    if not path.endswith(".npz"):
        path = path + ".npz"
    mp = getattr(runner, "_mp", False)
    dm = runner.delay_model
    c = runner.counters
    payload = dict(
        t0=runner.t0,
        chunk_idx=runner.chunk_idx,
        acc_spectra=runner._acc_spectra,
        acc_integrated=runner._acc_integrated,
        acc_first_chunk=runner._acc_first_chunk,
        config_hash=runner.cfg.config_hash(),
        host_tail=(runner._host_tail if runner._host_tail is not None
                   else np.zeros(0, np.int8)),
        # delay/weight model state (SURVEY.md §5 checkpoint row)
        delay_d0=dm.d0, delay_d1=dm.d1, delay_p0=dm.p0, delay_p1=dm.p1,
        delay_d2=dm.d2, delay_p2=dm.p2, delay_t_ref=dm.t_ref,
        delay_max=dm.max_delay,
        gains=np.asarray(runner.gains),
        counters=np.array([c.chunks_in, c.chunks_dropped, c.samples_in,
                           c.spectra_out, c.dumps], np.int64),
    )
    if mp:
        path = _proc_path(path)
        payload["process_shape"] = np.array(
            [jax.process_index(), jax.process_count()], np.int64)
        for name in _SHARDED_MP:
            _pack_shards(payload, name, getattr(runner, name))
    else:
        payload["history"] = np.asarray(runner.history)
        payload["vis_acc"] = np.asarray(runner.vis_acc)
        payload["weights"] = np.asarray(runner.weights)
    np.savez(path, **payload)
    return path


def load_state(runner, path: str) -> None:
    """Restore a runner's carry in place; config hash must match.
    Multi-process: call from EVERY process with the SAME logical
    ``path`` used at save time (each loads its own per-process file);
    process count and shard layout must match the save."""
    import jax
    import jax.numpy as jnp
    import os
    mp = getattr(runner, "_mp", False)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"      # accept the pre-normalisation name
    if mp:
        if not path.endswith(".npz"):
            path = path + ".npz"
        path = _proc_path(path)
        if not os.path.exists(path):
            raise ValueError(
                f"multi-process checkpoint file {path} not found — "
                "was the save made with the same process count "
                f"({jax.process_count()})?")
    z = np.load(path, allow_pickle=False)
    saved_hash = str(z["config_hash"])
    if saved_hash != runner.cfg.config_hash():
        raise ValueError(
            f"checkpoint config hash {saved_hash} != runner config "
            f"{runner.cfg.config_hash()}")
    if mp:
        saved_n = int(z["process_shape"][1])
        if saved_n != jax.process_count():
            raise ValueError(
                f"checkpoint saved with {saved_n} processes, restoring "
                f"under {jax.process_count()}")
        hist_shape = tuple(
            int(hi) - int(lo) for lo, hi in z["history_idx0"])
    else:
        hist_shape = z["history"].shape
    want = tuple(runner.history.addressable_shards[0].data.shape) \
        if mp else tuple(runner.history.shape)
    if tuple(hist_shape) != want:
        raise ValueError(
            f"checkpoint history shape {tuple(hist_shape)} != runner's "
            f"{want}{' (per-process shard)' if mp else ''} — saved "
            "with a different delay lead-in, time sharding or mesh "
            "layout")
    if mp:
        runner.history = _unpack_shards(z, "history", runner.history)
        runner.vis_acc = _unpack_shards(z, "vis_acc", runner.vis_acc)
        runner.weights = _unpack_shards(z, "weights", runner.weights)
    else:
        runner.history = jnp.asarray(z["history"])
        runner.vis_acc = jnp.asarray(z["vis_acc"])
        runner.weights = jnp.asarray(z["weights"])
    runner.t0 = int(z["t0"])
    runner.chunk_idx = int(z["chunk_idx"])
    runner._acc_spectra = int(z["acc_spectra"])
    runner._acc_integrated = int(z["acc_integrated"])
    if "acc_first_chunk" in z.files:
        runner._acc_first_chunk = int(z["acc_first_chunk"])
    if "host_tail" in z.files and z["host_tail"].size:
        runner._host_tail = z["host_tail"].copy()
    if "delay_d0" in z.files:
        if int(z["delay_max"]) != runner.max_delay:
            # the runner's host-tail buffer / step program were built
            # for ITS delay model's max_delay: restoring a different
            # one would either silently skip the coarse gather (runner
            # md=0) or feed a wrong-shaped tail — resume with a runner
            # constructed over an equivalent DelayModel instead
            raise ValueError(
                f"checkpoint delay max_delay {int(z['delay_max'])} != "
                f"runner's {runner.max_delay}; build the resuming "
                "runner with a DelayModel of the same max_delay")
        dm = runner.delay_model
        dm.d0 = z["delay_d0"].copy()
        dm.d1 = z["delay_d1"].copy()
        dm.p0 = z["delay_p0"].copy()
        dm.p1 = z["delay_p1"].copy()
        if "delay_d2" in z.files:
            dm.d2 = z["delay_d2"].copy()
            dm.p2 = z["delay_p2"].copy()
            dm.t_ref = int(z["delay_t_ref"])
        else:
            # round-3 checkpoint (linear model, epoch 0)
            dm.d2 = np.zeros_like(dm.d0)
            dm.p2 = np.zeros_like(dm.p0)
            dm.t_ref = 0
        dm.max_delay = int(z["delay_max"])
        runner.gains = (np.asarray(z["gains"]) if mp
                        else jnp.asarray(z["gains"]))
        c = z["counters"]
        runner.counters = dataclasses.replace(
            runner.counters, chunks_in=int(c[0]), chunks_dropped=int(c[1]),
            samples_in=int(c[2]), spectra_out=int(c[3]), dumps=int(c[4]))
