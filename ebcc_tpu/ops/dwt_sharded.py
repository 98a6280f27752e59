"""Distributed CDF 9/7 DWT: intra-frame spatial tiling with halo exchange.

The reference processes each 721x1440 frame whole on one core; SURVEY.md
§2.4 calls out intra-frame spatial decomposition with halo exchange for the
lifting stencils as the device-native capability with no reference counterpart.
This module implements it: frames are row-sharded over a mesh axis, the
row-direction lifting runs locally, and the column-direction lifting
exchanges one boundary row per lifting step with the neighbouring shard via
``jax.lax.ppermute`` (4 exchanges per level each way).  The computation is
**bit-identical** to the single-device transform (ops/dwt.py): shard
boundaries see true neighbour values; domain edges apply the same
edge/reflect rules.

Layout note: each shard keeps a *local* Mallat pyramid of its row band, so
the global array is a row-permuted Mallat layout (each subband is evenly
row-sharded).  :func:`canonical_row_order` gives the permutation to the
single-device layout.

Constraints: the local row count per shard must satisfy
``(H / nshards) >> levels >= 4`` and W must divide ``2**levels`` as usual.

All functions here are written to run INSIDE ``jax.shard_map`` (they use
``jax.lax.axis_index``/``ppermute`` on the given axis name); see
:func:`make_sharded_dwt2d` for a jitted end-to-end wrapper.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .dwt import ALPHA, BETA, DELTA, GAMMA, XI, dwt1d, idwt1d


def _axis_size(axis_name):
    return jax.lax.psum(1, axis_name)


def _from_next(rows, axis_name):
    """First row of the NEXT shard (last shard receives zeros)."""
    n = _axis_size(axis_name)
    perm = [(i, i - 1) for i in range(1, n)]
    return jax.lax.ppermute(rows[..., 0:1, :], axis_name, perm)


def _from_prev(rows, axis_name):
    """Last row of the PREVIOUS shard (first shard receives zeros)."""
    n = _axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(rows[..., -1:, :], axis_name, perm)


def _next_ctx(v, axis_name, edge):
    """Row following the local block: neighbour's first row, or ``edge``
    (a [..., 1, W] slice of v) on the global last shard."""
    n = _axis_size(axis_name)
    is_last = jax.lax.axis_index(axis_name) == n - 1
    recv = _from_next(v, axis_name)
    return jnp.where(is_last, edge, recv)


def _prev_ctx(v, axis_name, edge):
    """Row preceding the local block: neighbour's last row, or ``edge`` on
    the global first shard."""
    is_first = jax.lax.axis_index(axis_name) == 0
    recv = _from_prev(v, axis_name)
    return jnp.where(is_first, edge, recv)


def _shift_up(v, ctx):
    """v[i+1] with the cross-shard continuation row appended."""
    return jnp.concatenate([v[..., 1:, :], ctx], axis=-2)


def _shift_down(v, ctx):
    """v[i-1] with the cross-shard continuation row prepended."""
    return jnp.concatenate([ctx, v[..., :-1, :]], axis=-2)


def col_dwt_level(x, axis_name):
    """One column-direction analysis level of [..., Hs, W] row shards.

    Mirrors ops.dwt.dwt1d along axis -2 with distributed boundary handling:
    predict steps extend with the true next-shard row (edge-duplicate at the
    global bottom), update steps with the true previous-shard row (reflect
    at the global top) — exactly dwt.h:81-111 semantics.
    """
    even = x[..., 0::2, :]
    odd = x[..., 1::2, :]
    even_next = _shift_up(even, _next_ctx(even, axis_name,
                                          even[..., -1:, :]))
    d = odd + ALPHA * (even + even_next)
    d_prev = _shift_down(d, _prev_ctx(d, axis_name, d[..., 1:2, :]))
    s = even + BETA * (d + d_prev)
    s_next = _shift_up(s, _next_ctx(s, axis_name, s[..., -2:-1, :]))
    d = d + GAMMA * (s + s_next)
    d_prev = _shift_down(d, _prev_ctx(d, axis_name, d[..., 1:2, :]))
    s = s + DELTA * (d + d_prev)
    return jnp.concatenate([s * XI, d / XI], axis=-2)


def col_idwt_level(x, axis_name):
    """Inverse of :func:`col_dwt_level` (dwt.h:113-144 semantics)."""
    n2 = x.shape[-2] // 2
    s = x[..., :n2, :] / XI
    d = x[..., n2:, :] * XI
    d_prev = _shift_down(d, _prev_ctx(d, axis_name, d[..., 1:2, :]))
    s = s - DELTA * (d + d_prev)
    s_next = _shift_up(s, _next_ctx(s, axis_name, s[..., -2:-1, :]))
    d = d - GAMMA * (s + s_next)
    d_prev = _shift_down(d, _prev_ctx(d, axis_name, d[..., 1:2, :]))
    even = s - BETA * (d + d_prev)
    even_next = _shift_up(even, _next_ctx(even, axis_name,
                                          even[..., -1:, :]))
    odd = d - ALPHA * (even + even_next)
    out = jnp.stack([even, odd], axis=-2)  # [..., n2, 2, W]
    return out.reshape(*x.shape[:-2], 2 * n2, x.shape[-1])


def dwt2d_multi_sharded(x, levels: int, axis_name: str):
    """Multi-level 2-D DWT of row-sharded [..., Hs, W] (inside shard_map).

    Level i transforms the local top-left (Hs >> i, W >> i) region: the row
    pass is local (W unsharded), the column pass exchanges halos.  Result is
    the per-shard Mallat layout (see module docstring).
    """
    hs, w = x.shape[-2], x.shape[-1]
    for i in range(levels):
        hh, ww = hs >> i, w >> i
        sub = x[..., :hh, :ww]
        sub = dwt1d(sub)                      # rows (local)
        sub = col_dwt_level(sub, axis_name)   # columns (halo exchange)
        x = x.at[..., :hh, :ww].set(sub)
    return x


def idwt2d_multi_sharded(x, levels: int, axis_name: str):
    """Inverse of :func:`dwt2d_multi_sharded`."""
    hs, w = x.shape[-2], x.shape[-1]
    for i in range(levels - 1, -1, -1):
        hh, ww = hs >> i, w >> i
        sub = x[..., :hh, :ww]
        sub = col_idwt_level(sub, axis_name)
        sub = idwt1d(sub)
        x = x.at[..., :hh, :ww].set(sub)
    return x


def to_canonical(gathered: np.ndarray, nshards: int,
                 levels: int) -> np.ndarray:
    """Rearrange the gathered per-shard pyramid into the single-device
    Mallat layout (inverse: :func:`from_canonical`).

    Columns created at level l (cols [W>>l, W>>(l-1))) underwent l vertical
    transforms, so each column group has its own row mapping: within it,
    vertical rows decompose as [s-depth-l | d_l | ... | d_1], and the
    depth-k s/d sequences are evenly sharded (shard j holds indices
    [j*(hs>>k), (j+1)*(hs>>k))).
    """
    h, w = gathered.shape[-2], gathered.shape[-1]
    hs = h // nshards

    def smap(l):  # canonical s-depth-l row m -> gathered row
        m = np.arange(h >> l)
        q = hs >> l
        return (m // q) * hs + (m % q)

    def dmap(k):  # canonical d-depth-k row m -> gathered row
        m = np.arange(h >> k)
        q = hs >> k
        return (m // q) * hs + q + (m % q)

    def rowmap(l):  # vertical layout after l levels
        return np.concatenate([smap(l)] +
                              [dmap(k) for k in range(l, 0, -1)])

    out = np.empty_like(gathered)
    # column group for cols [0, W>>L) uses depth L; group l uses depth l
    groups = [(0, w >> levels, levels)]
    for l in range(levels, 0, -1):
        groups.append((w >> l, w >> (l - 1), l))
    for lo, hi, l in groups:
        out[..., :, lo:hi] = gathered[..., rowmap(l), lo:hi]
    return out


def make_sharded_dwt2d(mesh, levels: int, axis: str = "space"):
    """Jitted (forward, inverse) over a mesh: [B, H, W] with H sharded.

    Returns functions operating on arrays sharded
    ``PartitionSpec(None, axis, None)``; outputs keep that sharding in the
    per-shard Mallat layout.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(None, axis, None)

    @functools.partial(
        jax.jit,
        in_shardings=NamedSharding(mesh, spec),
        out_shardings=NamedSharding(mesh, spec))
    def fwd(x):
        return jax.shard_map(
            lambda v: dwt2d_multi_sharded(v, levels, axis),
            mesh=mesh, in_specs=spec, out_specs=spec)(x)

    @functools.partial(
        jax.jit,
        in_shardings=NamedSharding(mesh, spec),
        out_shardings=NamedSharding(mesh, spec))
    def inv(x):
        return jax.shard_map(
            lambda v: idwt2d_multi_sharded(v, levels, axis),
            mesh=mesh, in_specs=spec, out_specs=spec)(x)

    return fwd, inv
