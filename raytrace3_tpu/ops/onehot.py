"""One-hot contractions replacing small-table gathers.

XLA lowers ``tbl[idx]`` to a gather whose cost is per index, regardless of
how small the table is.  For the renderer's tiny tables (5 planes, 3
spheres, 9 materials) a one-hot contraction is bandwidth-bound elementwise
work instead: build ``(R, K)`` one-hot masks and reduce.  It was much the
faster at the photon walk's R ~ 1e5 per segment on the accelerator this
renderer was first built for; not yet re-measured on the GPU.

Use ONLY for small K (≲ 64): the one-hot intermediate is (R, K).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_f32(idx: jnp.ndarray, k: int) -> jnp.ndarray:
    """(R,) int -> (R, K) f32 one-hot (clipped indices select nothing
    outside [0, K))."""
    return (idx[:, None] == jnp.arange(k, dtype=idx.dtype)).astype(jnp.float32)


def take_rows(tbl: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``tbl[idx]`` for a small table: (K, ...) x (R,) -> (R, ...).

    Exact for f32 tables; bool tables round-trip through f32 exactly; int
    tables are exact up to 2^24 (one-hot sums select a single element, so
    no rounding ever occurs — the cast is the only constraint).
    """
    k = tbl.shape[0]
    oh = onehot_f32(idx, k)                              # (R, K)
    flat = tbl.reshape(k, -1)                            # (K, M)
    # precision=HIGHEST: a reduced-precision matmul (bf16, or TF32 on a
    # GPU) ROUNDS THE TABLE VALUES (the one-hot side is exact either way) —
    # scene coordinates like 81.6 lose ~0.4% in bf16, which put bounce
    # origins ~half a unit off the surfaces and inflated renders ~1.27x via
    # spurious self-re-intersections (found by the C++ crossval).
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    if tbl.dtype == jnp.bool_:
        out = mm(oh, flat.astype(jnp.float32)) > 0.5
    elif jnp.issubdtype(tbl.dtype, jnp.integer):
        out = jnp.round(mm(oh, flat.astype(jnp.float32))).astype(tbl.dtype)
    else:
        out = mm(oh, flat.astype(jnp.float32)).astype(tbl.dtype)
    return out.reshape((idx.shape[0],) + tbl.shape[1:])


def pick_columns(arr: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """``arr[arange(R), col]`` for small column counts: (R, K) x (R,) -> (R,).

    Replaces the per-row gather with a masked reduce.
    """
    k = arr.shape[1]
    oh = col[:, None] == jnp.arange(k, dtype=col.dtype)  # (R, K) bool
    if arr.dtype == jnp.bool_:
        return jnp.any(oh & arr, axis=1)
    return jnp.sum(jnp.where(oh, arr, 0), axis=1)
