"""Flux deposit: accumulate photon deposits into hit points.

Reference: the FLANN kd-tree radius search + neighbour loop
(raytracer/Raytracer.h:92-98, 137-159, 370-381) — one tree query PER photon
deposit, single-threaded, with the neighbour filter
``hp->n . N > 1e-3 && |hp->pos - x|^2 <= hp->R2`` and the accumulation
``hp->tao += hp->wgt * flux / pi; hp->newN++`` (Raytracer.h:154-157).

Batched replacements (SURVEY.md C17, BASELINE.json):

1. ``deposit_bruteforce`` — the ALL-PAIRS formulation.  The neighbour mask
   is an elementwise distance test and the flux accumulation is
   ``mask @ flux``, a thin matmul.  Chunked over deposits so nothing
   quadratic is held in device memory at once.  Exactly equal to the
   kd-tree result (it IS the brute-force oracle), trivially differentiable,
   and the default for small canvases.

2. ``ops/deposit_pallas.py`` — the banded Triton kernel for the GPU: visits
   only each hit-point tile's candidate deposits, exactly.

The search radius is the global INIT_R2 = 2.0 like the reference
(Raytracer.h:85,146 — quirk #6: the global radius never tracks the
per-hit-point shrink; correctness comes from the per-neighbour r2 re-check,
which we keep as the actual filter).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Deposits, HitPoints

#: Normal-agreement threshold (Raytracer.h:154).
NORMAL_DOT_MIN = 1e-3

#: Flux accumulation matmul: exact fp32 (the mask is 0/1 so only the flux
#: values lose bits under a reduced-precision matmul — bf16, or TF32 on a
#: GPU; HIGHEST keeps them).
_PREC = jax.lax.Precision.HIGHEST


def pair_d2_ndot(hp_pos, hp_n, dp, dn):
    """Exact pairwise |h - d|^2 and n_h . n_d, (C, J) by broadcast.

    NOT the |h|^2 + |d|^2 - 2 h.d matmul identity: reduced-precision
    matmul inputs (bf16, TF32) against ~1e2-scale scene coordinates yield
    d^2 errors of TENS of units vs the r^2 = 2.0 threshold (and even an
    fp32 matmul cancels ~1e4-scale terms to resolve ~1 unit).  The broadcast
    difference form is exact where it matters (small separations); the pair
    test was never real matmul work anyway (K = 3).
    """
    d2 = (
        (hp_pos[:, 0, None] - dp[None, :, 0]) ** 2
        + (hp_pos[:, 1, None] - dp[None, :, 1]) ** 2
        + (hp_pos[:, 2, None] - dp[None, :, 2]) ** 2
    )
    ndot = (
        hp_n[:, 0, None] * dn[None, :, 0]
        + hp_n[:, 1, None] * dn[None, :, 1]
        + hp_n[:, 2, None] * dn[None, :, 2]
    )
    return d2, ndot


def _chunk_contrib(hp_pos, hp_n, hp_r2, hp_valid, dp, dn, df, dv,
                   kernel: str = "box"):
    """Contribution of one deposit chunk to every hit point.

    Returns (d_count (C,), d_flux (C, 3)); d_flux EXCLUDES the wgt/pi factor
    (applied once by the caller).

    ``kernel``: the density kernel weighting each neighbour's flux.
      * "box" — the reference's uniform disc (Raytracer.h:156): weight 1.
      * "epanechnikov" — weight 2 (1 - d2/r2): integrates to 1 over the
        disc like the box (same 1/(pi r2) image normalisation applies), but
        the weight is CONTINUOUS at the radius boundary, so the estimator's
        a.e. derivative w.r.t. positions and r2 EQUALS its distributional
        derivative — the boundary term that makes box-kernel geometry
        gradients unusable (docs/INVERSE_CTRL.json) vanishes.  Plain-AD
        differentiable end to end (d2 and r2 feed the weight).
    The photon COUNT stays box-counted under both kernels (it drives the
    reference's radius shrink, Raytracer.h:69-79, whose semantics we keep).
    """
    d2, ndot = pair_d2_ndot(hp_pos, hp_n, dp, dn)        # (C, J)
    mask = (
        (d2 <= hp_r2[:, None])
        & (ndot > NORMAL_DOT_MIN)
        & dv[None, :]
        & hp_valid[:, None]
    )
    w = mask.astype(dp.dtype)
    if kernel == "epanechnikov":
        r2s = jnp.where(hp_r2 > 0, hp_r2, 1.0)
        wf = w * 2.0 * (1.0 - d2 / r2s[:, None])
    elif kernel == "box":
        wf = w
    else:
        raise ValueError(f"unknown deposit kernel: {kernel}")
    return jnp.sum(w, axis=1), jnp.matmul(wf, df, precision=_PREC)


def deposit_bruteforce(hp: HitPoints, dep: Deposits, chunk: int = 4096,
                       kernel: str = "box"):
    """All-pairs deposit accumulation, chunked over deposits.

    Returns:
      d_nphot: (C,) photon count increments (reference ``newN++``),
      d_tao:   (C, 3) flux increments ``wgt * sum(k_w * flux) / pi``.
    ``kernel``: see ``_chunk_contrib`` — "box" (reference parity, default)
    or "epanechnikov" (smooth opt-in for geometry gradients).
    """
    D = dep.pos.shape[0]
    pad = (-D) % chunk
    dp = jnp.pad(dep.pos, ((0, pad), (0, 0)))
    dn = jnp.pad(dep.n, ((0, pad), (0, 0)))
    df = jnp.pad(dep.flux, ((0, pad), (0, 0)))
    dv = jnp.pad(dep.valid, (0, pad))
    n_chunks = (D + pad) // chunk

    # checkpoint: under reverse-mode AD (the smooth-kernel geometry-grad
    # path) the scan would otherwise SAVE every (C, chunk) pair matrix —
    # n_chunks x rounds of ~75 MB ran out of device memory at 48^2;
    # recomputing the chunk contribution in the backward is ~free (it is
    # two broadcasts + a thin matmul) and drops the residuals to O(C).
    @jax.checkpoint
    def body(carry, idx):
        cnt, fl = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, idx * chunk, chunk)
        dc, dfl = _chunk_contrib(
            hp.pos, hp.n, hp.r2, hp.valid, sl(dp), sl(dn), sl(df), sl(dv),
            kernel=kernel,
        )
        return (cnt + dc, fl + dfl), None

    (cnt, fl), _ = jax.lax.scan(
        body,
        (jnp.zeros(hp.capacity, dep.pos.dtype),
         jnp.zeros((hp.capacity, 3), dep.pos.dtype)),
        jnp.arange(n_chunks),
    )
    d_tao = hp.wgt * fl / jnp.pi                         # Raytracer.h:156
    return cnt, d_tao


def deposit_bruteforce_epa(hp: HitPoints, dep: Deposits, chunk: int = 4096):
    """The smooth-kernel (Epanechnikov) bruteforce deposit — the opt-in
    geometry-gradient estimator (``kernel="epanechnikov"`` above)."""
    return deposit_bruteforce(hp, dep, chunk=chunk, kernel="epanechnikov")
