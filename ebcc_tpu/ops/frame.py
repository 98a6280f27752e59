"""Frame preparation: padding, scaling, DC removal.

Batched equivalents of the reference's framing code
(/root/reference/src/spiht/dwt.h:35-72 ``load_image`` and :252-301
``sub_dc``/``add_dc``/``normalize``), batched over a leading frame axis.
"""

from __future__ import annotations

import jax.numpy as jnp

U16_MAX = 65535.0


def padded_size(n: int, levels: int) -> int:
    """Smallest multiple of 2**(levels+1) that is >= n (dwt.h:42-45)."""
    m = 1 << (levels + 1)
    return ((n + m - 1) // m) * m


def pad_symmetric(x, levels: int):
    """Pad ``[..., H, W]`` on the right/bottom to multiples of 2**(levels+1).

    Matches load_image (dwt.h:61-70): right pad mirrors the last columns,
    bottom pad mirrors the last rows of the *original* region, and the
    bottom-right corner is zero.
    """
    h, w = x.shape[-2], x.shape[-1]
    hp, wp = padded_size(h, levels), padded_size(w, levels)
    ey, ex = hp - h, wp - w
    if ex:
        right = x[..., :, w - ex:][..., :, ::-1]
        xw = jnp.concatenate([x, right], axis=-1)
    else:
        xw = x
    if ey:
        bottom = x[..., h - ey:, :][..., ::-1, :]
        if ex:
            corner = jnp.zeros((*x.shape[:-2], ey, ex), dtype=x.dtype)
            bottom = jnp.concatenate([bottom, corner], axis=-1)
        xw = jnp.concatenate([xw, bottom], axis=-2)
    return xw


def crop(x, h: int, w: int):
    return x[..., :h, :w]


def minmax(x):
    """Per-frame (leading axes kept) min/max over the trailing two dims."""
    mn = jnp.min(x, axis=(-2, -1))
    mx = jnp.max(x, axis=(-2, -1))
    return mn, mx


def scale_to_u16(x, mn, mx):
    """((x - min) / (max - min)) * 65535, truncated toward zero.

    Matches the C cast-to-uint16 semantics (j2k_codec.h:523-526).  Returns
    float32 holding integer values in [0, 65535]; constant fields map to 0.
    """
    rng = mx - mn
    safe = jnp.where(rng > 0, rng, 1.0)
    y = (x - mn[..., None, None]) / safe[..., None, None] * U16_MAX
    return jnp.trunc(jnp.clip(y, 0.0, U16_MAX))


def unscale_from_u16(y, mn, mx):
    """y / 65535 * (max - min) + min (j2k_codec.h:1086-1088)."""
    return y / U16_MAX * (mx - mn)[..., None, None] + mn[..., None, None]


def sub_dc_floor(x):
    """Subtract the floored mean over the trailing two dims (dwt.h:252-267).

    Returns (centred, dc) where dc has the leading batch shape.
    """
    dc = jnp.floor(jnp.mean(x, axis=(-2, -1)))
    return x - dc[..., None, None], dc


def floor_toward_zero(x):
    """Truncate coefficients toward zero (dwt.h:288-301 ``normalize``)."""
    return jnp.trunc(x)
