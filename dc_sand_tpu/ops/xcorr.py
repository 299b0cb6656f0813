"""X-engine cross-correlation CMAC (C8) + integration (C9).

Golden semantics: :func:`dc_sand_tpu.golden.chain.xcorr` over the canonical
:func:`~dc_sand_tpu.golden.chain.baseline_pairs` ordering (2080 baselines x
4 pol products at 64 ants, BASELINE.json:5,9,10).

The CMAC is a *batched int8 matrix product* — per channel, with
A = Ar + j*Ai the (antpol, time) int8 matrix,

    V = A A^H  =  (Ar Ar^T + Ai Ai^T)  +  j (Ai Ar^T - Ar Ai^T)

computed as s8 x s8 -> s32 ``dot_general`` calls batched over channels;
integration over the time axis happens *inside* the product's
contraction at full int32 precision, so the visibilities are exact.

The streaming path (:func:`xcorr_accumulate`, used by ``make_step``)
carries ONE PACKED (k, ap, ap) int32 plane as the integration
accumulator: vr = Ar Ar^T + Ai Ai^T is SYMMETRIC and
vi = Ai Ar^T - Ar Ai^T is ANTISYMMETRIC with a zero diagonal, so the
upper triangle (incl. diagonal) holds vr and the strict lower triangle
holds vi with zero information loss (see :func:`acc_shape`).  Baselines
are extracted (and the triangles unpacked) ONCE per accumulator dump
(:func:`extract_vis` in the runner), not per chunk — per SURVEY.md C8/C9.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dc_sand_tpu.golden.chain import baseline_pairs

__all__ = ["xcorr", "xcorr_full", "extract_baselines", "extract_vis",
           "xcorr_accumulate", "acc_shape"]


def _vr_vi_operands(ar: jax.Array, ai: jax.Array):
    """Column-stacked operands for the two-block CMAC form.

    With A = Ar + j*Ai, the visibilities need only TWO real blocks

        vr = Ar Ar^T + Ai Ai^T  =  [Ar | Ai] [Ar | Ai]^T
        vi = Ai Ar^T - Ar Ai^T  =  [Ai | Ar] [Ar | -Ai]^T

    — each ONE matmul contracting over 2b columns.  Same MAC count as
    a (2ap, 2ap) stacked-block form, but the products (and the
    accumulator they feed) are HALF the size: the ArAi^T/AiAr^T
    sub-blocks are only ever consumed as these two combinations.  int32
    addition is associative, so the contraction regrouping is exact.

    Negating int8 ``ai`` is safe: the quantiser saturates to
    [-127, 127], so -128 (whose negation would wrap) never occurs.
    """
    cr = jnp.concatenate([ar, ai], axis=-1)    # (..., ap, 2b)
    cil = jnp.concatenate([ai, ar], axis=-1)
    cir = jnp.concatenate([ar, -ai], axis=-1)
    return cr, cil, cir


def xcorr_full(q: jax.Array) -> jax.Array:
    """Full correlation matrix from channel-major quantised spectra.

    ``q: (k, ant, pol, b, 2)`` int8 (corner-turned F-engine output) ->
    ``full: (k, ap, ap, 2)`` int32 with ``ap = ant*n_pols + pol``, last axis
    (re, im), integrated over the ``b`` spectra axis.
    """
    k, n_ants, n_pols, b, _ = q.shape
    ap = n_ants * n_pols
    a = q.reshape(k, ap, b, 2)
    cr, cil, cir = _vr_vi_operands(a[..., 0], a[..., 1])
    return jnp.stack([_bdot(cr, cr), _bdot(cil, cir)], axis=-1)


def extract_baselines(full: jax.Array, n_ants: int,
                      n_pols: int) -> jax.Array:
    """(k, ap, ap, 2) int32 -> (n_bl, pol_i, pol_j, k, 2) int32 over the
    canonical i<=j baseline ordering."""
    pairs = baseline_pairs(n_ants)
    p = np.arange(n_pols)
    rows = pairs[:, 0, None] * n_pols + p[None, :]  # (n_bl, pol)
    cols = pairs[:, 1, None] * n_pols + p[None, :]
    out = full[:, rows[:, :, None], cols[:, None, :]]  # (k, bl, pi, pj, 2)
    return jnp.moveaxis(out, 0, 3)


def acc_shape(n_ants: int, n_pols: int, n_chans: int) -> tuple:
    """Shape of the streaming X-engine integration accumulator:
    ``(k, ap, ap)`` int32 — ONE packed plane per channel.

    ``vr = ArAr^T + AiAi^T`` is symmetric and ``vi = AiAr^T - ArAi^T``
    is antisymmetric with a zero diagonal (``vi[i,i] = sum ai*ar -
    sum ar*ai = 0``), so one plane carries both exactly:

        acc[k, r, c] = vr[r, c]   for r <= c   (incl. the diagonal)
        acc[k, r, c] = vi[r, c]   for r >  c

    and :func:`extract_vis` reconstructs ``vr[r, c] = acc[c, r]`` /
    ``vi[r, c] = -acc[c, r]`` for the other triangle at dump cadence.
    Packing is an elementwise int32 select on the dot outputs — exact —
    and int32 addition keeps the accumulate linear, so the SP
    cross-shard dump sum works on the packed form unchanged.  A quarter
    of a (k, 2ap, 2ap) carry: the accumulator's read+write per chunk,
    the checkpoint and the SP dump-sum wire all shrink with it."""
    ap = n_ants * n_pols
    return (n_chans, ap, ap)


def _pack_mask(ap: int):
    """Boolean (ap, ap) upper-triangle-inclusive mask: True where the
    packed plane holds vr (r <= c), False where it holds vi (r > c)."""
    idx = np.arange(ap)
    return jnp.asarray(idx[:, None] <= idx[None, :])


def _bdot(x: jax.Array, y: jax.Array) -> jax.Array:
    """Channel-batched ``x @ y^T`` over the spectra axis, s8 x s8 -> s32."""
    return jax.lax.dot_general(
        x, y, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)


def xcorr_accumulate(acc: jax.Array, q: jax.Array) -> jax.Array:
    """One chunk of X-engine integration into the packed plane.

    ``acc: (k, ap, ap) int32`` packed [vr upper | vi lower] (see
    :func:`acc_shape`); ``q: (k, ant, pol, b, 2) int8`` corner-turned
    F-engine output.  Returns the bumped accumulator
    (:func:`extract_vis` unpacks at dump time).
    """
    k, n_ants, n_pols, b, _ = q.shape
    ap = n_ants * n_pols
    a = q.reshape(k, ap, b, 2)
    cr, cil, cir = _vr_vi_operands(a[..., 0], a[..., 1])
    return acc + jnp.where(_pack_mask(ap), _bdot(cr, cr), _bdot(cil, cir))


def extract_vis(acc: jax.Array, n_ants: int, n_pols: int) -> jax.Array:
    """Dump-time extraction from the packed streaming accumulator.

    ``acc: (k, ap, ap) int32`` packed [vr upper | vi lower] (see
    :func:`acc_shape`; from :func:`xcorr_accumulate`) ->
    ``(n_bl, pi, pj, k, 2) int32`` canonical visibilities.  Unpacks the
    triangles by symmetry (``vr = vr^T``, ``vi = -vi^T``, ``vi`` zero
    diagonal) then extracts; runs once per accumulator dump (the runner
    jits it), so the cost is amortised over the whole integration
    window.
    """
    ap = acc.shape[-1]
    idx = np.arange(ap)
    upper = jnp.asarray(idx[:, None] <= idx[None, :])   # vr lives here
    lower = jnp.asarray(idx[:, None] > idx[None, :])    # vi lives here
    acc_t = jnp.swapaxes(acc, -1, -2)
    vr = jnp.where(upper, acc, acc_t)
    vi = jnp.where(lower, acc, jnp.where(upper & ~jnp.eye(
        ap, dtype=bool), -acc_t, 0))
    full = jnp.stack([vr, vi], axis=-1)
    return extract_baselines(full, n_ants, n_pols)


def xcorr(q: jax.Array) -> jax.Array:
    """Channel-major quantised spectra -> integrated visibilities.

    ``q: (k, ant, pol, b, 2)`` int8 -> ``(n_bl, pol, pol, k, 2)`` int32.
    Headroom: |V| <= 2 * 127^2 * b; keep ``b`` per accumulation below
    ~66k spectra (int32 bound) — the runner's dump cadence enforces this.
    """
    _, n_ants, n_pols, _, _ = q.shape
    return extract_baselines(xcorr_full(q), n_ants, n_pols)
