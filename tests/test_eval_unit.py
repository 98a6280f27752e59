"""The candidate-evaluation unit (pipeline._Eval) against a plain float64
numpy reference: closed-form coefficient reconstruction at the candidate
-> inverse CDF 9/7 lifting -> dequantise -> (max excess, violation
fraction) per frame.

The unit runs in float32 under XLA, the reference in float64, so the
stats agree to a tolerance: |maxd - ref| <= STAT_TOL (data units, about
50 float32 ulps of the ~300-unit field) and the violation counts differ
by at most the points whose float64 excess lies within STAT_TOL of the
target.  Feasibility decisions (maxd <= 0, viol <= q) must be identical
wherever the float64 reference is not within that tolerance of the
threshold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ebcc_tpu.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu.codec.pipeline import FrameCodec, _Eval
from ebcc_tpu.ops import bitplane as bp
from ebcc_tpu.ops import dwt

STAT_TOL = 2e-3
B = 2


# ---------------- float64 reference ----------------

def _idwt1d(x):
    """Inverse CDF 9/7 lifting along the last axis (float64)."""
    n2 = x.shape[-1] // 2
    s = x[..., :n2] / dwt.XI
    d = x[..., n2:] * dwt.XI

    def refl_prev(v):
        return np.concatenate([v[..., 1:2], v[..., :-1]], axis=-1)

    def refl_next(v):
        return np.concatenate([v[..., 1:], v[..., -2:-1]], axis=-1)

    def edge_next(v):
        return np.concatenate([v[..., 1:], v[..., -1:]], axis=-1)

    s = s - dwt.DELTA * (d + refl_prev(d))
    d = d - dwt.GAMMA * (s + refl_next(s))
    even = s - dwt.BETA * (d + refl_prev(d))
    odd = d - dwt.ALPHA * (even + edge_next(even))
    out = np.empty(x.shape, np.float64)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _idwt2d_multi(x, levels):
    x = x.copy()
    h, w = x.shape[-2:]
    for i in range(levels - 1, -1, -1):
        hh, ww = h >> i, w >> i
        sub = np.swapaxes(_idwt1d(np.swapaxes(x[..., :hh, :ww], -1, -2)),
                          -1, -2)  # columns first
        x[..., :hh, :ww] = _idwt1d(sub)  # then rows
    return x


def _msb(mag):
    return np.where(mag > 0, np.frexp(mag.astype(np.float64))[1] - 1, -1)


def _coef_trunc(ci, b, js, jr, nchunks):
    """Midpoint reconstruction truncated inside plane b after js
    significance and jr refinement chunks (None: plane b complete)."""
    mag = np.abs(ci).astype(np.int64)
    msb = _msb(mag)
    bb = np.asarray(b)[:, None, None]
    old, new = msb > bb, msb == bb
    if js is None:
        vis, beff = old | new, np.broadcast_to(bb, mag.shape)
    else:
        sid = (np.arange(ci.shape[1]) * nchunks // ci.shape[1])[None, :, None]
        vis = old | (new & (sid < np.asarray(js)[:, None, None]))
        beff = np.where(old & (sid >= np.asarray(jr)[:, None, None]),
                        bb + 1, bb)
    q = (mag >> beff) << beff
    rec = np.where(vis, q + (2.0 ** beff - 1) / 2, 0.0)
    return np.where(ci < 0, -rec, rec)


def _coef_masked(ci, b, drop, nchunks):
    """Midpoint reconstruction with the plane-b chunks in ``drop`` absent."""
    mag = np.abs(ci).astype(np.int64)
    sid = np.arange(ci.shape[1]) * nchunks // ci.shape[1]
    d = np.asarray(b)[:, None, None] + drop[:, sid][:, :, None].astype(int)
    q = mag >> d
    rec = np.where(q > 0, (q << d) + (2.0 ** d - 1) / 2, 0.0)
    return np.where(ci < 0, -rec, rec)


def _layer_recon(coef, weights, levels, dc, lo, hi, h, w, scale):
    x = _idwt2d_multi(coef / weights, levels) + dc[:, None, None]
    x = np.clip(x, 0.0, scale)[:, :h, :w]
    return x / scale * (hi - lo)[:, None, None] + lo[:, None, None]


def _stats(data_ref, rec, tgt3):
    err = np.abs(data_ref - rec) - tgt3
    return err.max(axis=(-2, -1)), (err > 0).mean(axis=(-2, -1)), err


# ---------------- cases ----------------

def _codec(h, w):
    max_lv = max(0, (min(h, w) - 1).bit_length() - 2)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, max_batch=B)
    cfg = dataclasses.replace(cfg, base_levels=min(cfg.base_levels, max_lv),
                              residual_levels=min(cfg.residual_levels,
                                                  max_lv))
    return FrameCodec(h, w, cfg)


@pytest.fixture(scope="module", params=[(96, 160), (45, 77)],
                ids=["96x160", "45x77"])
def layers(request):
    """Both layers of one frame pair: integer coefficients, the f32
    reconstruction functions the unit calls, and their float64 twins."""
    h, w = request.param
    c = _codec(h, w)
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:h, 0:w]
    base = 260 + 25 * np.sin(y / h * np.pi) * np.cos(x / w * 2 * np.pi)
    data = np.stack([base + rng.normal(0, 0.3, base.shape)
                     for _ in range(B)]).astype(np.float32)
    dj = jnp.asarray(data)
    mn, mx, _, dc, ci = c._base_transform(dj)
    an = bp.analyze(ci, c.base.spec)
    # base reconstruction at a mid plane: the residual layer's input
    base_rec = c._base_recon(c._recon_at(an, c.base, jnp.full(B, 8),
                                         jnp.full(B, 3)), mn, mx, dc)
    rmin, rmax, dcr, cir = c._resid_transform(dj - base_rec)
    f64 = (lambda v: np.asarray(v, np.float64))
    return {
        "data": data, "h": h, "w": w,
        "base": dict(
            an=an, geom=c.base, ci=np.asarray(ci),
            fn=lambda rc: c._base_recon(rc, mn, mx, dc),
            ref=lambda coef: _layer_recon(
                coef, f64(c.wb), c.base.levels, f64(dc), f64(mn), f64(mx),
                h, w, 65535.0)),
        "resid": dict(
            an=bp.analyze(cir, c.resid.spec), geom=c.resid,
            ci=np.asarray(cir),
            fn=lambda rc: base_rec + c._resid_recon(rc, rmin, rmax, dcr),
            ref=lambda coef: f64(base_rec) + _layer_recon(
                coef, f64(c.wr), c.resid.levels, f64(dcr), f64(rmin),
                f64(rmax), h, w, 255.0)),
    }


def _targets(kind, shape, data):
    rng = np.random.default_rng(11)
    if kind == "scalar":
        return np.asarray([0.3, 0.9], np.float32)[:shape[0]]
    return (0.2 + 0.6 * rng.random(shape)).astype(np.float32)


def _candidates(mode, nchunks):
    """(args for _Eval, args for the reference) per candidate."""
    rng = np.random.default_rng(3)
    out = []
    if mode == "trunc":
        for b, js, jr in ((6, None, None), (3, None, None), (5, 3, 0),
                          (4, nchunks, 2), (2, 1, 0)):
            bv = np.full(B, b, np.int32)
            if js is None:
                out.append(((bv,), (bv, None, None)))
            else:
                jsv = np.full(B, js, np.int32)
                jrv = np.full(B, jr, np.int32)
                out.append(((bv, jsv, jrv), (bv, jsv, jrv)))
    else:
        for b in (6, 4, 2):
            drop = rng.random((B, nchunks)) < 0.5
            bv = np.full(B, b, np.int32)
            out.append(((bv, drop), (bv, drop)))
    return out


@pytest.mark.parametrize("target", ["scalar", "field"])
@pytest.mark.parametrize("mode", ["trunc", "masked"])
@pytest.mark.parametrize("kind", ["base", "resid"])
def test_eval_unit_matches_float64_reference(layers, kind, mode, target):
    lay = layers[kind]
    data = layers["data"]
    tgt = _targets(target, data.shape, data)
    tgt3 = tgt if tgt.ndim == 3 else tgt[:, None, None]
    ev = _Eval(lay["an"], lay["geom"], lay["fn"], jnp.asarray(data),
               jnp.asarray(tgt))
    nch = lay["geom"].spec.nchunks
    n = data.shape[1] * data.shape[2]
    decided = 0
    for ev_args, ref_args in _candidates(mode, nch):
        if mode == "trunc":
            b, *chunks = ev_args
            maxd, viol = ev.trunc(jnp.asarray(b),
                                  *(jnp.asarray(v) for v in chunks))
            coef = _coef_trunc(lay["ci"], *ref_args, nch)
        else:
            maxd, viol = ev.masked(jnp.asarray(ev_args[0]),
                                   jnp.asarray(ev_args[1]))
            coef = _coef_masked(lay["ci"], *ref_args, nch)
        rmaxd, rviol, err = _stats(data.astype(np.float64),
                                   lay["ref"](coef), tgt3)
        maxd, viol = np.asarray(maxd), np.asarray(viol)
        np.testing.assert_allclose(maxd, rmaxd, rtol=0, atol=STAT_TOL)
        near = (np.abs(err) <= STAT_TOL).sum(axis=(-2, -1))
        assert np.all(np.abs(viol - rviol) * n <= near + 0.5)
        sure = np.abs(rmaxd) > STAT_TOL
        np.testing.assert_array_equal((maxd <= 0)[sure], (rmaxd <= 0)[sure])
        for q in (1e-6, 1e-3, 0.05):
            sure_q = np.abs(rviol - q) * n > near
            np.testing.assert_array_equal((viol <= q)[sure_q],
                                          (rviol <= q)[sure_q])
        decided += int(sure.sum())
    assert decided > 0  # the decisions were exercised, not all ambiguous
