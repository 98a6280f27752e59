"""bp.segment_counts against a brute-force numpy count of the bits each
(plane, segment) emits, straight from the coder's emission rules:

* group level k (G..1): cells whose own pyramid max is <= p while their
  parent's is >= p (for k = G the parent is the frame's max plane);
* level 0, per stripe j: significance = pixels whose 2x2 parent is >= p
  and whose own msb is <= p; sign = msb == p; refinement = msb > p.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ebcc_tpu.ops import bitplane as bp


def _pool(x):
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).max(axis=(2, 4))


def _up(x):
    return x.repeat(2, axis=-2).repeat(2, axis=-1)


def brute_counts(coef, spec):
    mag = np.abs(coef).astype(np.int64)
    msb = np.where(mag > 0, np.frexp(mag.astype(np.float64))[1] - 1, -1)
    smax = [msb]
    for _ in range(spec.group_levels):
        smax.append(_pool(smax[-1]))
    max_step = np.maximum(msb.max(axis=(1, 2)), 0)
    sid = np.arange(spec.height) * spec.nchunks // spec.height
    g, j = spec.group_levels, spec.nchunks
    out = np.zeros((coef.shape[0], spec.nplanes, 3 * j + g), np.int64)
    for q, p in enumerate(range(spec.nplanes - 1, -1, -1)):
        col = 0
        for k in range(g, 0, -1):
            if k == g:
                par = (max_step >= p)[:, None, None]
            else:
                par = _up(smax[k + 1]) >= p
            out[:, q, col] = ((smax[k] <= p) & par).sum(axis=(1, 2))
            col += 1
        par0 = _up(smax[1]) >= p
        for jj in range(j):
            m = (sid == jj)[None, :, None]
            out[:, q, col] = (par0 & (msb <= p) & m).sum(axis=(1, 2))
            out[:, q, col + 1] = ((msb == p) & m).sum(axis=(1, 2))
            col += 2
        for jj in range(j):
            m = (sid == jj)[None, :, None]
            out[:, q, col] = ((msb > p) & m).sum(axis=(1, 2))
            col += 1
    return out


@pytest.mark.parametrize("h,w,g,j,zero", [
    (64, 96, 4, 8, False), (32, 32, 3, 4, False), (48, 80, 2, 8, False),
    (64, 96, 4, 8, True)], ids=["64x96", "32x32", "48x80", "all-zero"])
def test_segment_counts_match_brute_force(h, w, g, j, zero):
    spec = bp.CoderSpec(height=h, width=w, group_levels=g, nplanes=13,
                        nchunks=j)
    rng = np.random.default_rng(h * w + g)
    coef = rng.integers(-2000, 2000, (3, h, w))
    coef[:, ::2] = 0  # whole insignificant subtrees
    if zero:
        coef[:] = 0   # msb == -1 everywhere
    got = bp.segment_counts(bp.analyze(jnp.asarray(coef, jnp.int32), spec),
                            spec)
    np.testing.assert_array_equal(np.asarray(got), brute_counts(coef, spec))
