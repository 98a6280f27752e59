"""Data-preparation utilities: ensemble-spread interpolation, npy caching.

Parity with the reference's data-processing layer, which produces the
per-point error bounds for the realistic pointwise workflow (bounds =
interpolated ensemble spread):

* fixed-factor upsampling — 3x time (linear thirds, constant fill at the
  end), 2x latitude (midpoints, first/last kept), 2x longitude (midpoints
  with 360-degree wraparound), preserving the subsampling identity
  ``in == out[0::3, 0::2, 0::2]``
  (/root/reference/scripts/data_processing/interpolate_npy_array.py:36-60);
* grid-to-grid interpolation with the lon-360 wraparound column
  (/root/reference/scripts/run_pointwise.py:63-68) plus linear time
  interpolation onto a reanalysis time axis;
* skip-if-exists npy caching
  (/root/reference/scripts/data_processing/build_npy_storage.py:13-20).

Everything is vectorised numpy (the reference fans the same math over a
``multiprocessing.Pool``); spatial interpolation is exact bilinear on the
regular source grid where the reference uses ``scipy.griddata(linear)``
(piecewise-linear on a Delaunay triangulation of the same points — equal
on grid lines, within the cell-diagonal split elsewhere).
"""

from __future__ import annotations

import os

import numpy as np


def upsample_3t_2s(arr: np.ndarray) -> np.ndarray:
    """[T, H, W] -> [3T, 2H-1, 2W] fixed-factor upsample.

    Time: each step split into thirds (linear toward the next step,
    constant fill after the last).  Latitude: midpoint insertion keeping
    both poles.  Longitude: midpoint insertion with wraparound (the last
    inserted column averages the last and FIRST columns — lon 360 == 0).
    Subsampling identity: ``arr == out[0::3, 0::2, 0::2]``.
    """
    arr = np.asarray(arr, np.float32)
    t, h, w = arr.shape
    a1 = arr
    a2 = np.concatenate((arr[1:], arr[-1:]), axis=0)
    out_t = np.empty((3 * t, h, w), np.float32)
    out_t[0::3] = a1
    out_t[1::3] = (2 * a1 + a2) / 3
    out_t[2::3] = (a1 + 2 * a2) / 3

    out_h = np.empty((3 * t, 2 * h - 1, w), np.float32)
    out_h[:, 0::2] = out_t
    out_h[:, 1::2] = (out_t[:, :-1] + out_t[:, 1:]) / 2

    out_w = np.empty((3 * t, 2 * h - 1, 2 * w), np.float32)
    out_w[:, :, 0::2] = out_h
    out_w[:, :, 1::2] = (out_h + np.concatenate(
        (out_h[:, :, 1:], out_h[:, :, 0:1]), axis=2)) / 2
    return out_w


def _wrap_lon(data, lon):
    """Append the wraparound column: lon[0] + 360 repeats column 0
    (run_pointwise.py:63-68)."""
    lon_ext = np.concatenate([lon, lon[0:1] + 360.0])
    data_ext = np.concatenate([data, data[..., 0:1]], axis=-1)
    return data_ext, lon_ext


def _interp_coeff(src: np.ndarray, dst: np.ndarray):
    """Indices + weights for 1-D linear interpolation (clamped)."""
    src = np.asarray(src, np.float64)
    order = np.argsort(src)
    s = src[order]
    idx = np.clip(np.searchsorted(s, dst, side="right") - 1, 0, len(s) - 2)
    denom = s[idx + 1] - s[idx]
    wgt = np.where(denom > 0, (dst - s[idx]) / np.where(denom > 0, denom, 1),
                   0.0)
    wgt = np.clip(wgt, 0.0, 1.0)  # clamp outside the source range
    return order[idx], order[idx + 1], wgt.astype(np.float64)


def interpolate_to_grid(data, src_lat, src_lon, dst_lat, dst_lon, *,
                        wrap_lon: bool = True) -> np.ndarray:
    """Bilinear [..., LAT, LON] regridding with lon-360 wraparound.

    ``src_lat``/``src_lon`` are the source coordinate vectors (either
    ordering), ``dst_*`` the target vectors.  With ``wrap_lon`` the source
    gains a duplicate first column at lon+360 so targets between the last
    source longitude and 360 interpolate across the seam.
    """
    data = np.asarray(data, np.float32)
    src_lon = np.asarray(src_lon, np.float64)
    dst_lon_arr = np.asarray(dst_lon, np.float64)
    if wrap_lon:
        data, src_lon = _wrap_lon(data, src_lon)
    i0, i1, wy = _interp_coeff(src_lat, np.asarray(dst_lat, np.float64))
    j0, j1, wx = _interp_coeff(src_lon, dst_lon_arr)
    wy = wy[:, None]
    wx = wx[None, :]
    d00 = data[..., i0[:, None], j0[None, :]]
    d01 = data[..., i0[:, None], j1[None, :]]
    d10 = data[..., i1[:, None], j0[None, :]]
    d11 = data[..., i1[:, None], j1[None, :]]
    out = ((1 - wy) * (1 - wx) * d00 + (1 - wy) * wx * d01 +
           wy * (1 - wx) * d10 + wy * wx * d11)
    return out.astype(np.float32)


def interpolate_time(data, src_times, dst_times) -> np.ndarray:
    """Linear interpolation of [T, ...] onto a new time axis (clamped at
    the ends, like xarray's interp over the reanalysis axis)."""
    data = np.asarray(data, np.float32)
    src = np.asarray(src_times, np.float64)
    dst = np.asarray(dst_times, np.float64)
    i0, i1, w = _interp_coeff(src, dst)
    w = w.reshape(-1, *([1] * (data.ndim - 1)))
    return ((1 - w) * data[i0] + w * data[i1]).astype(np.float32)


def ensemble_spread_to_reanalysis(spread, src_lat, src_lon, src_times,
                                  dst_lat, dst_lon, dst_times) -> np.ndarray:
    """Full pipeline of interpolate_ensemble_to_reanalysis
    (run_pointwise.py:44-100): spatial bilinear with wraparound, then
    temporal linear onto the reanalysis axis.  The result is the per-point
    error-bound field for pointwise compression."""
    spatial = interpolate_to_grid(spread, src_lat, src_lon,
                                  dst_lat, dst_lon)
    return interpolate_time(spatial, src_times, dst_times)


def cache_npy(path: str, produce, *, overwrite: bool = False) -> np.ndarray:
    """Skip-if-exists npy cache (build_npy_storage.py:13-20 idempotency):
    load ``path`` if present, else call ``produce()``, save, return."""
    if not overwrite and os.path.exists(path):
        return np.load(path)
    arr = np.asarray(produce())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)
    return arr


def synthetic_frames(n: int, h: int = 721, w: int = 1440,
                     sigma: float = 0.05, seed: int = 0) -> np.ndarray:
    """Seeded stand-in for ERA5 2 m temperature: the smooth field
    ``260 + 25 sin(pi y/h) cos(2 pi x/w)`` plus independent N(0, sigma)
    noise per frame.  float32 [n, h, w]."""
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return np.stack([base + rng.normal(0, sigma, base.shape).astype(
        np.float32) for _ in range(n)])
