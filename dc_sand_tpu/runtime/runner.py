"""Chunked real-time runner (C21) with observability counters.

Host loop over the jitted step from
:func:`dc_sand_tpu.models.pipeline.make_step`: feed chunk, advance delay
polynomials, dump integrations at the accumulation cadence, carry FIR
history + coarse-delay lead-in + accumulators on device (donated).

Fault semantics (SURVEY.md §5): a dropped chunk is replaced by zeros —
stream timing advances, FIR history stays continuous, and the dump
metadata records how many spectra actually integrated, so downstream
scaling stays honest.  ``save_state``/``load_state`` snapshot the carry
at any chunk boundary for restart.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dc_sand_tpu.config import ChainConfig
from dc_sand_tpu.models.pipeline import make_step, mode_for
from dc_sand_tpu.runtime.delays import DelayModel

logger = logging.getLogger("dc_sand_tpu.runner")

__all__ = ["FXRunner", "RunnerCounters", "Dump"]


@dataclasses.dataclass
class RunnerCounters:
    chunks_in: int = 0
    chunks_dropped: int = 0
    samples_in: int = 0
    spectra_out: int = 0
    dumps: int = 0


@dataclasses.dataclass
class Dump:
    """One accumulator dump: visibilities + integration bookkeeping."""
    vis: np.ndarray            # (n_bl, P, P, K, 2) int32
    n_spectra: int             # spectra actually integrated (drops excluded)
    n_spectra_nominal: int     # window length in spectra
    first_chunk: int


class FXRunner:
    """Streaming pipeline runner for any of the five configs."""

    def __init__(self, cfg: ChainConfig, window: np.ndarray,
                 delay_model: Optional[DelayModel] = None,
                 gains: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None,
                 mesh=None, coarse_on_host: bool = True):
        self.cfg = cfg
        self.mode = mode_for(cfg)
        self.mesh = mesh
        self.delay_model = delay_model or DelayModel.zeros(
            cfg.n_ants, cfg.n_pols)
        self.max_delay = self.delay_model.max_delay
        # integer-sample (coarse) delay is a read-pointer offset: applied
        # on the host feed path by default (see make_step docstring)
        self.coarse_on_host = coarse_on_host and cfg.apply_delay
        # multi-PROCESS SPMD (one runner per process, one global mesh):
        # sharded step inputs must be global jax.Arrays — the
        # source feeds each host its LOCAL antennas' chunk and the
        # runner assembles the global array (SURVEY.md §2.3 DP row)
        self._mp = mesh is not None and jax.process_count() > 1
        self._n_ants_local = cfg.n_ants
        if self._mp:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from dc_sand_tpu.parallel import FX_AXIS, TIME_AXIS
            from dc_sand_tpu.parallel.distributed import \
                local_antenna_range
            a0, a1 = local_antenna_range(cfg.n_ants)
            self._n_ants_local = a1 - a0
            # shardings reused every chunk (the feed path is hot),
            # keyed by step-argument role to match make_step's in_specs
            if cfg.time_shards > 1:
                # multi-process SP: antennas over fx (= processes),
                # sample stream over the PROCESS-LOCAL time axis — the
                # ingest-locality layout (one host = its antennas'
                # whole contiguous stream; its local devices split it in
                # time).  A time axis that crosses processes would make
                # each host's addressable chunk slab non-contiguous AND
                # put the per-chunk halo between hosts — refuse it
                # rather than assemble it slowly.
                devs = mesh.devices   # (time, fx)
                for f in range(devs.shape[1]):
                    if len({d.process_index for d in devs[:, f]}) != 1:
                        raise NotImplementedError(
                            "multi-process SP streaming needs the time "
                            "axis process-local (build_mesh(..., "
                            "time_local=True)): one host ingests its "
                            "antennas' contiguous stream; a time shard "
                            "crossing hosts would split that stream "
                            "across NICs and put the overlap-save halo "
                            "between hosts")
                t3 = P(FX_AXIS, None, TIME_AXIS)
                self._sh = {
                    "history": NamedSharding(mesh, t3),
                    "chunk": NamedSharding(mesh, t3),
                    "coarse": NamedSharding(mesh, P()),
                    "frac": NamedSharding(mesh, t3),
                    "phase": NamedSharding(mesh, t3),
                    "weights": NamedSharding(mesh, P(None, FX_AXIS)),
                    "vis": NamedSharding(mesh, P(TIME_AXIS, FX_AXIS)),
                }
            else:
                a_sh = NamedSharding(mesh, P(FX_AXIS))
                self._sh = {
                    "history": a_sh, "chunk": a_sh, "coarse": a_sh,
                    "frac": a_sh, "phase": a_sh,
                    "weights": NamedSharding(mesh, P(None, FX_AXIS)),
                    "vis": a_sh,
                }
        # fengine mode under multi-process emits antenna-sharded
        # per-chunk spectra; on_output hands them over as jax Arrays
        # (each host consumes its own addressable antenna shards — the
        # same pass-through contract as EP beam shards below)
        if self._mp and self.coarse_on_host and self.max_delay:
            raise ValueError(
                "multi-process runner: apply coarse delay at ingest "
                "placement (NativeIngest.set_delay) or on device "
                "(coarse_on_host=False) — the host-tail path is "
                "single-process")
        dev_max_delay = 0 if self.coarse_on_host else self.max_delay
        self._step = make_step(cfg, window, max_delay=dev_max_delay,
                               mesh=mesh, coarse_on_host=self.coarse_on_host)
        self._window = np.asarray(window)
        self._dev_max_delay = dev_max_delay
        self._scan_window = None   # built lazily by run_batched
        a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
        self.gains = jnp.asarray(
            gains if gains is not None
            else np.stack([np.full((k,), cfg.quant_scale, np.float32),
                           np.zeros((k,), np.float32)], -1))
        self.weights = jnp.asarray(
            weights if weights is not None
            else np.zeros((max(cfg.n_beams, 1), a, k, 2), np.float32))
        from dc_sand_tpu.models.pipeline import history_len, zero_vis_acc
        self.history = jnp.zeros(
            (a, p, history_len(cfg, self._dev_max_delay)), jnp.int8)
        if self._mp:
            # carries/parameters as GLOBAL sharded arrays (the step's
            # in_specs); gains/reset stay host-numpy — fully-replicated
            # args may be identical per-process ndarrays
            self.history = self._put_full(self.history, "history")
            self.weights = self._put_full(self.weights, "weights")
            self.gains = np.asarray(self.gains)
        self._host_tail = (np.zeros((a, p, self.max_delay), np.int8)
                           if self.coarse_on_host and self.max_delay
                           else None)
        self.vis_acc = zero_vis_acc(cfg)
        if self._mp and self.mode == "fx":
            self.vis_acc = self._put_full(self.vis_acc, "vis")
        if self.mode == "fx":
            # dump-time baseline extraction (jitted once; n_ants/n_pols
            # are static) — the accumulator itself carries the packed
            # (k, ap, ap) triangle plane between chunks.  SP fx carries
            # one partial accumulator per time shard (leading axis); the
            # cross-shard sum rides the dump cadence here, not the chunk
            # cadence
            from dc_sand_tpu import ops as _ops

            def _ex(acc):
                if cfg.time_shards > 1:
                    acc = acc.sum(axis=0)
                return _ops.extract_vis(acc, a, p)

            if self._mp:
                # dump-time all-gather: every host gets the full
                # visibility set (np.asarray needs full addressability).
                # Dump cadence makes this cheap relative to the
                # integration window.
                from jax.sharding import NamedSharding, PartitionSpec
                self._extract = jax.jit(
                    _ex, out_shardings=NamedSharding(mesh,
                                                     PartitionSpec()))
            else:
                self._extract = jax.jit(_ex)
        # int32 CMAC headroom (ops/xcorr.py): |V| <= 2*127^2*n_spectra
        max_spectra = (2 ** 31 - 1) // (2 * 127 * 127)
        if self.mode == "fx" and cfg.n_spectra_per_acc > max_spectra:
            raise ValueError(
                f"n_spectra_per_acc={cfg.n_spectra_per_acc} overflows the "
                f"int32 visibility accumulator (max {max_spectra})")
        self.counters = RunnerCounters()
        self.t0 = 0          # absolute sample index of next new sample
        self.chunk_idx = 0
        self._acc_spectra = 0       # spectra in current window (nominal)
        self._acc_integrated = 0    # spectra actually integrated
        self._acc_first_chunk = 0

    # ------------------------------------------------------------------
    def _put_full(self, arr, role: str):
        """Full-array-on-every-process -> global array with ``role``'s
        sharding (each process serves its addressable shards from its
        identical host copy)."""
        a = np.asarray(arr)
        return jax.make_array_from_callback(
            a.shape, self._sh[role], lambda idx: a[idx])

    def _put_chunk(self, chunk):
        """Source chunk -> device. Single-process: plain transfer.
        Multi-process: the source provides only this host's LOCAL
        antennas (rows ``local_antenna_range``); assemble the global
        antenna-sharded array from the per-process blocks.  Under SP
        the local slab additionally spans the full (process-local) time
        axis, so it is still one contiguous block per host."""
        if not self._mp:
            return jnp.asarray(chunk)
        local = np.asarray(chunk)
        return jax.make_array_from_process_local_data(
            self._sh["chunk"], local, (self.cfg.n_ants,) + local.shape[1:])

    # ------------------------------------------------------------------
    def run(self, source: Callable[[int], np.ndarray], n_chunks: int,
            on_dump: Optional[Callable[[Dump], None]] = None,
            on_output: Optional[Callable[[int, dict], None]] = None,
            drop_chunks: Iterable[int] = ()):
        """Process ``n_chunks``; returns (dumps, counters).

        ``source(chunk_idx)`` -> int8 ``(A, P, chunk_samples)``.
        ``on_output`` receives per-chunk outputs (spectra / beams) as
        numpy arrays — except outputs left sharded across OTHER hosts
        (EP beam shards under multi-host SPMD), which arrive as jax
        Arrays whose ``addressable_shards`` are this host's subset.
        ``drop_chunks``: chunk indices to fault-inject as zeros.
        """
        cfg = self.cfg
        b = cfg.spectra_per_chunk
        drop = frozenset(drop_chunks)
        dumps = []
        for _ in range(n_chunks):
            i = self.chunk_idx
            chunk, coarse, frac, phase, dropped = self._feed_chunk(
                i, drop, source)
            reset = self._acc_spectra == 0
            if reset:
                self._acc_first_chunk = i
            if self._mp:
                args = (self._put_chunk(chunk),
                        self._put_full(coarse, "coarse"),
                        self._put_full(frac, "frac"),
                        self._put_full(phase, "phase"),
                        self.gains, self.weights, np.asarray(reset))
            else:
                args = (jnp.asarray(chunk), jnp.asarray(coarse),
                        jnp.asarray(frac), jnp.asarray(phase),
                        self.gains, self.weights, jnp.asarray(reset))
            self.history, self.vis_acc, outputs = self._step(
                self.history, self.vis_acc, *args)
            if on_output is not None and outputs:
                # beam-sharded (EP) outputs span devices of OTHER
                # processes under multi-host SPMD — each host consumes
                # its own addressable beam shards, so those pass
                # through as jax Arrays instead of forcing a (crashing)
                # global materialisation
                on_output(i, {k: (np.asarray(v) if v.is_fully_addressable
                                  else v)
                              for k, v in outputs.items()})
            if self.mode == "fx":
                self._acc_spectra += b
                if not dropped:
                    self._acc_integrated += b
                if self._acc_spectra >= cfg.n_spectra_per_acc:
                    d = Dump(vis=np.asarray(self._extract(self.vis_acc)),
                             n_spectra=self._acc_integrated,
                             n_spectra_nominal=self._acc_spectra,
                             first_chunk=self._acc_first_chunk)
                    dumps.append(d)
                    self.counters.dumps += 1
                    if on_dump is not None:
                        on_dump(d)
                    self._acc_spectra = 0
                    self._acc_integrated = 0
        return dumps, self.counters

    # ------------------------------------------------------------------
    def _feed_chunk(self, i: int, drop: frozenset, source):
        """Shared per-chunk host feed for ``run``/``run_batched`` (the
        paths are documented as semantically identical and must not
        drift): fault injection, delay-model evaluation, host-side
        coarse delay, counter/clock bookkeeping.

        Host-side coarse delay is a read-pointer offset into
        ``[tail | chunk]``; the tail carries the previous chunk's last
        ``max_delay`` raw samples (zeros at stream start).  Vectorised:
        a zero-copy sliding-window view over the concatenated buffer +
        one take_along_axis gather — no per-stream Python loop in the
        real-time feed path.  (The truly free home for coarse delay is
        packet placement in the native ingest: NativeIngest.set_delay;
        see bench/ingest_bench.py for the at-rate comparison.)
        """
        cfg = self.cfg
        b = cfg.spectra_per_chunk
        n_ants_local = self._n_ants_local
        dropped = i in drop
        if dropped:
            chunk = np.zeros((n_ants_local, cfg.n_pols,
                              cfg.chunk_samples), np.int8)
            self.counters.chunks_dropped += 1
            logger.warning("chunk %d dropped (fault-injected)", i)
        else:
            chunk = source(i)
        coarse, frac, phase = self.delay_model.evaluate_chunk(
            self.t0, b, cfg.fft_size)
        if self._host_tail is not None:
            buf = np.concatenate([self._host_tail, chunk], axis=-1)
            md = self.max_delay
            win = np.lib.stride_tricks.sliding_window_view(
                buf, cfg.chunk_samples, axis=-1)   # (A, P, md+1, c)
            sel = (md - coarse.astype(np.int64))[..., None, None]
            chunk = np.ascontiguousarray(
                np.take_along_axis(win, sel, axis=2)[..., 0, :])
            if md:
                # .copy(): the tail is worth ~A*P*md bytes; keeping a
                # view would pin the whole chunk-sized concat buffer
                # between steps
                self._host_tail = buf[..., -md:].copy()
        self.counters.chunks_in += 1
        self.counters.samples_in += chunk.size
        self.counters.spectra_out += b
        self.t0 += cfg.chunk_samples
        self.chunk_idx += 1
        return chunk, coarse, frac, phase, dropped

    # ------------------------------------------------------------------
    def run_batched(self, source: Callable[[int], np.ndarray],
                    n_chunks: int,
                    on_dump: Optional[Callable[[Dump], None]] = None,
                    drop_chunks: Iterable[int] = ()):
        """Offline-reprocessing fast path (fx mode): scan one whole
        integration window's chunks in ONE device dispatch.

        Streaming ``run`` dispatches per chunk — right for real-time
        (bounded latency, the feed arrives chunkwise), but each
        dispatch pays fixed overheads that dominate when replaying
        RECORDED data as fast as possible.  Here the
        ``n_spectra_per_acc / spectra_per_chunk`` chunks of a dump
        window are stacked on the host and processed by a
        ``lax.scan`` over the SAME step program, so the device runs
        the whole window back to back.  Semantically
        identical to ``run`` — same carry, same drop bookkeeping, same
        dump extraction, proven bitwise by test — but per-chunk
        ``on_output`` is unavailable (nothing leaves the device mid-
        window).  Requires a dump-aligned ``n_chunks``.
        """
        cfg = self.cfg
        if self.mode != "fx":
            raise ValueError("run_batched is fx-mode only (other modes "
                             "emit per-chunk outputs; use run)")
        if self._mp:
            raise NotImplementedError(
                "run_batched is a single-process offline-replay path; "
                "multi-process streaming uses run()")
        b = cfg.spectra_per_chunk
        if cfg.n_spectra_per_acc % b:
            raise ValueError("n_spectra_per_acc must be a multiple of "
                             "spectra_per_chunk for the batched path")
        g = cfg.n_spectra_per_acc // b
        if n_chunks % g:
            raise ValueError(f"n_chunks must be dump-aligned "
                             f"(multiple of {g})")
        if self._acc_spectra:
            raise ValueError("run_batched must start at a dump boundary")
        if self._scan_window is None:
            inner = make_step(cfg, self._window,
                              max_delay=self._dev_max_delay,
                              mesh=self.mesh, donate=False,
                              coarse_on_host=self.coarse_on_host)

            def window_fn(hist, acc, chunks, coarses, fracs, phases,
                          gains, weights, resets):
                def body(carry, xs):
                    h, a_ = carry
                    ch, co, fd, ph, rs = xs
                    h, a_, _ = inner(h, a_, ch, co, fd, ph, gains,
                                     weights, rs)
                    return (h, a_), ()

                (hist, acc), _ = jax.lax.scan(
                    body, (hist, acc),
                    (chunks, coarses, fracs, phases, resets))
                return hist, acc

            self._scan_window = jax.jit(window_fn,
                                        donate_argnums=(0, 1))
        drop = frozenset(drop_chunks)
        dumps = []
        resets = jnp.asarray(np.arange(g) == 0)
        for _ in range(n_chunks // g):
            first_chunk = self.chunk_idx
            chunks, coarses, fracs, phases = [], [], [], []
            integrated = 0
            for _k in range(g):
                chunk, coarse, frac, phase, dropped = self._feed_chunk(
                    self.chunk_idx, drop, source)
                if not dropped:
                    integrated += b
                chunks.append(np.asarray(chunk))
                coarses.append(coarse)
                fracs.append(frac)
                phases.append(phase)
            self.history, self.vis_acc = self._scan_window(
                self.history, self.vis_acc,
                jnp.asarray(np.stack(chunks)),
                jnp.asarray(np.stack(coarses)),
                jnp.asarray(np.stack(fracs)),
                jnp.asarray(np.stack(phases)),
                self.gains, self.weights, resets)
            d = Dump(vis=np.asarray(self._extract(self.vis_acc)),
                     n_spectra=integrated,
                     n_spectra_nominal=g * b,
                     first_chunk=first_chunk)
            dumps.append(d)
            self.counters.dumps += 1
            if on_dump is not None:
                on_dump(d)
        return dumps, self.counters
