"""Banded photon deposit: exact flux accumulation with a Pallas Triton kernel.

Replaces the reference's per-photon FLANN kd-tree radius query
(raytracer/Raytracer.h:92-98, 137-159, 370-381).  The plain-XLA backend is
``render/deposit.py`` bruteforce (O(C x D) all pairs, the exact oracle);
this module visits only the candidate deposits of each hit-point tile.

Layout (banded keys):
  * key = x_bucket * Y_STRIDE + quantized(y), with bucket width 2r along x.
    Keys are int32 with y quantized to 1/8 unit and CONSERVATIVE floor/ceil
    window bounds, so no fp key-resolution margin is needed and exactness is
    preserved (windows are supersets; the in-kernel d2/r2/normal test is the
    true filter);
  * hit points live in a BUCKET-ALIGNED, tile-padded layout so every tile of
    ``tile`` consecutive slots belongs to exactly one bucket.  The layout
    depends only on positions and is built ONCE PER PASS (``prepare``), not
    per photon round;
  * a tile's neighbours lie in the 3 adjacent x-buckets within the tile's
    y-range +/- r: K = 3 deposit-lane intervals per tile, found by
    searchsorted against this round's sorted deposit keys and made disjoint
    by a cascade (``_window_lanes``).

Kernel (``_banded_kernel``): one program per hit-point tile.  The program
reads its own K interval bounds, walks each interval in ``chunk``-lane steps
with masked, coalesced loads of the sorted (9, Dp) deposit rows, evaluates
the (tile, chunk) pair test in registers and keeps four per-hit-point sums
(count, flux rgb) in the loop carry.  It stores once at the end: no state
crosses programs, so programs run in any order and need no atomics.  The
walk has no cap, so no candidate is ever dropped.

Pair math is the exact elementwise |h-d|^2 written exactly like
``render/deposit.py`` ``pair_d2_ndot``, so counts agree with the bruteforce
oracle bit for bit.

Cost: O(true candidate volume) elementwise work + one deposit sort per round.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.pytree import pytree_dataclass
from ..core.types import Deposits, HitPoints
from ..render.deposit import NORMAL_DOT_MIN

#: Reference fixed search radius^2 = 2.0 (Raytracer.h:85).
SEARCH_R = math.sqrt(2.0)
#: Static scene bounds along the bucket axis (reference scene fits easily).
DEFAULT_X_LO = -40.0
DEFAULT_X_HI = 200.0

#: Sentinel position for invalid/padding deposit lanes (fails any d2 test).
FAR = 1e9
#: Sort-key y quantisation: 1/8 scene unit over [y_lo, y_hi) (constructor
#: params; these are the reference-scene defaults).  int32 keys with
#: floor/ceil window bounds are exactly conservative — no fp margin.
Y_LO = -40.0
Y_HI = 240.0
YQ = 8.0
#: Deposit windows per tile: the tile's own x-bucket and its two neighbours.
K_WINDOWS = 3
#: Position axes of the x-buckets and of the sort key within a bucket.
AX, AY = 0, 1
#: Chunk starts are aligned down to this many lanes (128-byte rows) so the
#: deposit-row loads vectorise; the lane mask keeps the walk exact.
LANE_ALIGN = 32


@pytree_dataclass
class HpLayout:
    """Round-invariant hit-point side of the banded deposit (one per pass)."""

    packed: jnp.ndarray    # (8, c_pad) rows: pos xyz, n xyz, r2, unused
    g: jnp.ndarray         # (C,) layout slot of hit point i (dest o h_ord^-1)
    lo_keys: jnp.ndarray   # (n_tiles, K) window lower keys
    hi_keys: jnp.ndarray   # (n_tiles, K) window upper keys


def _banded_kernel(sk_ref, ek_ref, hp_ref, dep_ref, out_ref, *,
                   chunk: int, align: int):
    i = pl.program_id(0)
    # pair_d2_ndot's operand order, so d2/ndot round exactly like the oracle
    hx, hy, hz = hp_ref[0, :], hp_ref[1, :], hp_ref[2, :]
    nx, ny, nz = hp_ref[3, :], hp_ref[4, :], hp_ref[5, :]
    r2 = hp_ref[6, :]
    zeros = jnp.zeros(hx.shape, jnp.float32)
    acc = (zeros, zeros, zeros, zeros)
    lane = jnp.arange(chunk, dtype=jnp.int32)

    for k in range(K_WINDOWS):
        s = sk_ref[i * K_WINDOWS + k]
        e = ek_ref[i * K_WINDOWS + k]
        a0 = (s // align) * align
        n_chunks = jnp.where(e > s, (e - a0 + chunk - 1) // chunk, 0)

        def body(j, acc, s=s, e=e, a0=a0):
            start = pl.multiple_of(a0 + j * chunk, align)
            idx = start + lane
            ok = (idx >= s) & (idx < e)

            def row(r):
                return plgpu.load(dep_ref.at[r, pl.ds(start, chunk)])[None, :]

            d2 = ((hx[:, None] - row(0)) ** 2
                  + (hy[:, None] - row(1)) ** 2
                  + (hz[:, None] - row(2)) ** 2)
            ndot = (nx[:, None] * row(3) + ny[:, None] * row(4)
                    + nz[:, None] * row(5))
            m = ((d2 <= r2[:, None]) & (ndot > NORMAL_DOT_MIN)
                 & ok[None, :]).astype(jnp.float32)
            return (acc[0] + jnp.sum(m, axis=1),
                    acc[1] + jnp.sum(m * row(6), axis=1),
                    acc[2] + jnp.sum(m * row(7), axis=1),
                    acc[3] + jnp.sum(m * row(8), axis=1))

        acc = jax.lax.fori_loop(0, n_chunks, body, acc)

    for r in range(4):
        out_ref[r, :] = acc[r]


def banded_deposit_call(sk, ek, hp_rows, dep_rows, *, tile: int, chunk: int,
                        num_warps: int, num_stages: int,
                        interpret: bool = False):
    """Run the kernel: (4, c_pad) rows of (count, flux r, g, b).

    sk/ek: (n_tiles * K,) int32 disjoint lane intervals per tile, flattened;
    hp_rows: (8, c_pad) tile-padded hit points, c_pad a multiple of ``tile``;
    dep_rows: (9, Dp) sorted deposits, with Dp >= every interval end rounded
    up to ``LANE_ALIGN`` plus ``chunk`` so no chunk reads past the end.
    """
    c_pad = hp_rows.shape[1]
    assert c_pad % tile == 0, (c_pad, tile)
    return pl.pallas_call(
        functools.partial(_banded_kernel, chunk=chunk, align=LANE_ALIGN),
        grid=(c_pad // tile,),
        in_specs=[pl.no_block_spec, pl.no_block_spec,
                  pl.BlockSpec((8, tile), lambda i: (0, i)),
                  pl.no_block_spec],
        out_specs=pl.BlockSpec((4, tile), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((4, c_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="banded_deposit",
    )(sk, ek, hp_rows, dep_rows)


class BandedDeposit:
    """deposit_fn(hp, dep, prep=None) -> (d_nphot, d_tao), Triton-backed.

    ``prepare(hp)`` builds the round-invariant hit-point layout; pass its
    result back via ``prep=`` from inside the rounds loop to amortise the
    hit-point sort/scatter across all photon rounds of a pass.
    ``pack_state``/``packed_call``/``unpack_state`` run the rounds loop in
    layout space (``render/sppm.py``).

    ``tile``, ``chunk`` (powers of two) and ``num_warps``/``num_stages`` are
    the kernel's launch shape; the defaults are the fastest of a sweep at
    bench512 shapes on an H100 (scripts/deposit_sweep.py, docs/PERF.md).
    ``search_r`` must bound every hit point's radius (radii only shrink).
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests
    only).
    """

    def __init__(self, tile: int = 32, chunk: int = 32, num_warps: int = 4,
                 num_stages: int = 3, search_r: float = SEARCH_R,
                 x_lo: float = DEFAULT_X_LO, x_hi: float = DEFAULT_X_HI,
                 y_lo: float = Y_LO, y_hi: float = Y_HI,
                 interpret: bool = False):
        for name, v in (("tile", tile), ("chunk", chunk)):
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name} must be a power of two, got {v}")
        self.tile = tile
        self.chunk = chunk
        self.num_warps = num_warps
        self.num_stages = num_stages
        self.search_r = search_r
        self.bucket = 2.0 * search_r
        self.x_lo = x_lo
        self.n_buckets = int(math.ceil((x_hi - x_lo) / self.bucket)) + 1
        self.y_lo = y_lo
        self.y_range = int(math.ceil((y_hi - y_lo) * YQ))
        self.y_stride = self.y_range + 2
        self.interpret = interpret

    # -- helpers -----------------------------------------------------------
    def _bid(self, pos):
        """x-bucket id per row of ``pos``."""
        return jnp.clip(
            jnp.floor((pos[:, AX] - self.x_lo) / self.bucket)
            .astype(jnp.int32),
            0, self.n_buckets - 1,
        )

    def _yq(self, y):
        """Quantized sort coordinate (floor -> conservative with ceil hi)."""
        return jnp.clip(jnp.floor((y - self.y_lo) * YQ).astype(jnp.int32),
                        0, self.y_range - 1)

    def _c_pad(self, C: int) -> int:
        t = self.tile
        return ((C + t - 1) // t) * t + (self.n_buckets + 1) * t

    def _sentinel_key(self) -> int:
        """Key for invalid deposit lanes: beyond every window, including
        windows of the sentinel hit-point bucket."""
        return (self.n_buckets + 3) * self.y_stride

    # -- once per pass -----------------------------------------------------
    def prepare(self, hp: HitPoints) -> HpLayout:
        t = self.tile
        C = hp.capacity
        nb = self.n_buckets
        hkx = jnp.where(hp.valid, self._bid(hp.pos), nb)
        hkey = hkx * self.y_stride + jnp.where(
            hp.valid, self._yq(hp.pos[:, AY]), 0
        )
        # one variadic sort: permutation + bucket ids, no re-gather
        _, h_ord, kx_sorted = jax.lax.sort(
            (hkey, jnp.arange(C, dtype=jnp.int32), hkx), num_keys=1
        )

        counts = jnp.bincount(kx_sorted, length=nb + 1)
        padded = ((counts + t - 1) // t) * t
        offsets = jnp.concatenate(
            [jnp.zeros((1,), padded.dtype), jnp.cumsum(padded)[:-1]]
        )
        # Rank within the bucket run: first_idx[i] = index of the first
        # element sharing kx_sorted[i] (a cummax over run starts, O(C)).
        i_arange = jnp.arange(C, dtype=jnp.int32)
        is_start = jnp.concatenate(
            [jnp.ones((1,), bool), kx_sorted[1:] != kx_sorted[:-1]]
        )
        first_idx = jax.lax.cummax(jnp.where(is_start, i_arange, 0))
        dest = offsets[kx_sorted] + (i_arange - first_idx)

        c_pad = self._c_pad(C)
        n_tiles = c_pad // t
        rows = jnp.concatenate(
            [hp.pos, hp.n, jnp.full((C, 1), -1.0), jnp.zeros((C, 1))], axis=1,
        )
        # dest is ascending and unique by construction (bucket offsets +
        # within-bucket ranks).  Padding slots: position FAR, normal 0,
        # r2 = -1 (the d2 <= r2 test kills them).
        pad_row = jnp.asarray([FAR, FAR, FAR, 0.0, 0.0, 0.0, -1.0, 0.0],
                              jnp.float32)
        packed = jnp.tile(pad_row, (c_pad, 1)).at[dest].set(
            rows[h_ord], unique_indices=True, indices_are_sorted=True)

        slot_kx = jnp.zeros((c_pad,), jnp.int32).at[dest].set(
            kx_sorted, mode="drop", unique_indices=True,
            indices_are_sorted=True,
        )
        kb = jnp.max(slot_kx.reshape(n_tiles, t), axis=1)

        tv = jnp.zeros((c_pad,), bool).at[dest].set(
            hp.valid[h_ord], mode="drop", unique_indices=True,
            indices_are_sorted=True,
        ).reshape(n_tiles, t)
        ty = packed[:, AY].reshape(n_tiles, t)
        y_lo = jnp.where(tv, ty, jnp.inf).min(1) - self.search_r
        y_hi = jnp.where(tv, ty, -jnp.inf).max(1) + self.search_r
        dead = ~jnp.isfinite(y_lo)
        # Conservative quantized window bounds: floor for lo, ceil for hi.
        # The lo clip tops out at y_range - 1 to MATCH _yq's clip, so a
        # window whose y_lo lands above y_hi still covers deposits that
        # quantise to y_range - 1.
        ylo_q = jnp.clip(jnp.floor((y_lo - self.y_lo) * YQ), -1e9,
                         self.y_range - 1).astype(jnp.int32)
        yhi_q = jnp.clip(jnp.ceil((y_hi - self.y_lo) * YQ), -1e9,
                         self.y_range).astype(jnp.int32)

        offs = jnp.arange(-1, K_WINDOWS - 1, dtype=jnp.int32)   # ascending
        lo_keys = (kb[:, None] + offs[None, :]) * self.y_stride + ylo_q[:, None]
        hi_keys = (kb[:, None] + offs[None, :]) * self.y_stride + yhi_q[:, None]
        big = self._sentinel_key() + self.y_stride
        lo_keys = jnp.where(dead[:, None], big, lo_keys)
        hi_keys = jnp.where(dead[:, None], big, hi_keys)
        # hp-id -> layout slot, so per-round r2 refresh and result unpacking
        # are ONE scatter / ONE gather instead of permutation chains.
        g = jnp.zeros((C,), dest.dtype).at[h_ord].set(
            dest, unique_indices=True
        )
        return HpLayout(packed=packed.T, g=g, lo_keys=lo_keys,
                        hi_keys=hi_keys)

    # -- per round ---------------------------------------------------------
    def _dep_sorted(self, dep: Deposits):
        """Sort + pack the round's deposits: (dkeys, dep_rows).

        ``dep_rows`` is (9, Dp): pos xyz (FAR for invalid), n xyz, flux rgb,
        in key order.  One variadic ``lax.sort`` carries the key and all 9
        payload columns.  Dp leaves ``chunk`` lanes of FAR padding past the
        aligned end so every kernel load stays in bounds."""
        D = dep.pos.shape[0]
        Dp = (-(-D // LANE_ALIGN) * LANE_ALIGN) + self.chunk
        dkey = jnp.where(
            dep.valid,
            self._bid(dep.pos) * self.y_stride
            + self._yq(dep.pos[:, AY]),
            self._sentinel_key(),
        )
        okc = dep.valid[:, None]
        pos = jnp.where(okc, dep.pos, FAR)
        flux = jnp.where(okc, dep.flux, 0.0)
        out = jax.lax.sort(
            (dkey,
             pos[:, 0], pos[:, 1], pos[:, 2],
             dep.n[:, 0], dep.n[:, 1], dep.n[:, 2],
             flux[:, 0], flux[:, 1], flux[:, 2]),
            num_keys=1,
        )
        rows = jnp.stack(out[1:], axis=0)                   # (9, D)
        pad = jnp.zeros((9, Dp - D), jnp.float32).at[0:3].set(FAR)
        return out[0], jnp.concatenate([rows, pad], axis=1)

    def _window_lanes(self, prep: HpLayout, dkeys):
        """Exact per-(tile, window) lane intervals, disjoint via cascade.

        Returns (s, e) each (n_tiles, K): window k of tile i covers sorted
        deposit lanes [s[i,k], e[i,k]).  Windows are key-ordered so
        cascading each start past the previous end removes overlap without
        dropping any lane."""
        n_tiles = prep.lo_keys.shape[0]
        s_lane = jnp.searchsorted(dkeys, prep.lo_keys.reshape(-1),
                                  side="left").reshape(n_tiles, K_WINDOWS)
        e_lane = jnp.searchsorted(dkeys, prep.hi_keys.reshape(-1),
                                  side="right").reshape(n_tiles, K_WINDOWS)
        prev_e = jnp.zeros((n_tiles,), s_lane.dtype)
        s_cols, e_cols = [], []
        for k in range(K_WINDOWS):
            s_k = jnp.maximum(s_lane[:, k], prev_e)
            e_k = jnp.maximum(e_lane[:, k], s_k)
            s_cols.append(s_k)
            e_cols.append(e_k)
            prev_e = e_k
        return jnp.stack(s_cols, 1), jnp.stack(e_cols, 1)

    def _kernel_call(self, hp_rows: jnp.ndarray, dep: Deposits,
                     prep: HpLayout):
        """(cnt_pad (c_pad,), flux_pad (c_pad, 3)) in layout space."""
        dkeys, dep_rows = self._dep_sorted(dep)
        sk, ek = self._window_lanes(prep, dkeys)
        out = banded_deposit_call(
            sk.astype(jnp.int32).reshape(-1), ek.astype(jnp.int32).reshape(-1),
            hp_rows, dep_rows, tile=self.tile, chunk=self.chunk,
            num_warps=self.num_warps, num_stages=self.num_stages,
            interpret=self.interpret)
        return out[0], out[1:4].T

    # -- layout-space interface (state packed for the whole pass) ----------
    def pack_state(self, hp: HitPoints, prep: HpLayout):
        """Scatter per-pass hit-point state into layout space ONCE.

        Returns (r2_pad, wgt_pad): the rounds loop then runs entirely in
        layout space (``packed_call`` + elementwise PPM updates), unpacking
        once at pass end.
        """
        c_pad = prep.packed.shape[1]
        r2_pad = jnp.full((c_pad,), -1.0, jnp.float32).at[prep.g].set(
            jnp.where(hp.valid, hp.r2, -1.0), unique_indices=True,
            mode="drop",
        )
        wgt_pad = jnp.zeros((c_pad, 3), jnp.float32).at[prep.g].set(
            hp.wgt, unique_indices=True, mode="drop",
        )
        return r2_pad, wgt_pad

    def unpack_state(self, prep: HpLayout, *cols):
        """Gather layout-space per-hit-point arrays back to hp order."""
        return tuple(c[prep.g] for c in cols)

    def packed_call(self, r2_pad: jnp.ndarray, dep: Deposits,
                    prep: HpLayout):
        """Layout-space deposit: (cnt_pad, flux_pad).

        ``flux_pad`` is the raw neighbour-flux sum; the caller applies
        wgt * flux / pi with its layout-space wgt (Raytracer.h:156).
        Invalid/padding slots carry r2 = -1 so the d2 <= r2 test kills
        them — no valid mask is needed in layout space.
        """
        return self._kernel_call(prep.packed.at[6].set(r2_pad), dep, prep)

    def __call__(self, hp: HitPoints, dep: Deposits,
                 prep: HpLayout | None = None):
        if prep is None:
            prep = self.prepare(hp)
        # refresh the per-round r2 slot (radius shrink between rounds)
        hp_rows = prep.packed.at[6, prep.g].set(
            jnp.where(hp.valid, hp.r2, -1.0), unique_indices=True
        )
        cnt_pad, fl_pad = self._kernel_call(hp_rows, dep, prep)
        cnt, fl = self.unpack_state(prep, cnt_pad, fl_pad)
        return cnt, hp.wgt * fl / jnp.pi                    # Raytracer.h:156


def world_bounds_from_scene(scene, margin: float = 4.0 * SEARCH_R,
                            extra_points=None) -> dict:
    """Derive deposit world bounds from a scene's finite geometry.

    Collects sphere extents, Bezier control points, light positions, the
    pinned axes of axis-aligned planes, and optional ``extra_points`` (e.g.
    the camera position, which bounds where eye hit points can land), then
    pads by ``margin``.  Returns ``x_lo/x_hi/y_lo/y_hi/z_lo/z_hi``.

    Bounds only ever affect PERFORMANCE: out-of-range positions clamp into
    boundary buckets (exactness is preserved by the in-kernel d2 test) but
    crowd them.
    """
    import numpy as np

    pts = [np.asarray(scene.light_pos, np.float64)]
    if scene.spheres.count:
        c = np.asarray(scene.spheres.center, np.float64)
        r = np.asarray(scene.spheres.radius, np.float64)[:, None]
        pts += [c - r, c + r]
    if scene.has_bezier:
        pts.append(np.asarray(scene.bezier.ctrl, np.float64).reshape(-1, 3))
    if extra_points is not None:
        pts.append(np.asarray(extra_points, np.float64).reshape(-1, 3))
    P = np.concatenate(pts, 0)
    lo, hi = P.min(0), P.max(0)
    n = np.asarray(scene.planes.normal, np.float64)
    p0 = np.asarray(scene.planes.p0, np.float64)
    for i in range(n.shape[0]):
        ax = int(np.argmax(np.abs(n[i])))
        if abs(n[i, ax]) > 0.999:       # axis-aligned plane pins its axis
            lo[ax] = min(lo[ax], p0[i, ax])
            hi[ax] = max(hi[ax], p0[i, ax])
    lo -= margin
    hi += margin
    return dict(x_lo=float(lo[0]), x_hi=float(hi[0]),
                y_lo=float(lo[1]), y_hi=float(hi[1]),
                z_lo=float(lo[2]), z_hi=float(hi[2]))
