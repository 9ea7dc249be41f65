"""Masked index compaction via one stable sort.

Drop-in for ``jnp.nonzero(mask, size=cap, fill_value=fill)[0]`` on the hot
path.  XLA lowers sized-nonzero to a cumsum + index SCATTER; a stable
ascending sort of ``~mask`` puts the True lanes first in original order
with no scatter at all, and was the faster of the two on the accelerator
this renderer was first built for (identical outputs).  Not yet re-measured
on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compact_indices(mask: jnp.ndarray, cap: int,
                    fill: int | None = None) -> jnp.ndarray:
    """Indices of True lanes of ``mask`` in ascending order, ``fill``-padded.

    Exactly ``jnp.nonzero(mask, size=cap, fill_value=fill)[0]``: the first
    ``cap`` True-lane indices ascending; remaining slots (and True lanes
    beyond ``cap`` — callers account for those as overflow) become ``fill``
    (default: ``mask.shape[0]``).
    """
    N = mask.shape[0]
    if fill is None:
        fill = N
    assert cap <= N, (cap, N)
    _, idx = jax.lax.sort_key_val(
        jnp.logical_not(mask).astype(jnp.int32),
        jnp.arange(N, dtype=jnp.int32),
        is_stable=True,
    )
    idx = idx[:cap]
    return jnp.where(mask[idx], idx, fill)
