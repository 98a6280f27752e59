"""Edge cases and input validation (reference parity: check_nan_inf
j2k_codec.h:451-458, const-field shortcut :515, container sanity)."""

import numpy as np
import pytest

import ebcc_tpu
from ebcc_tpu import EBCCConfig, ResidualMode
from ebcc_tpu.codec import container


def small_cfg(**kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("mode", ResidualMode.MAX_ERROR)
    kw.setdefault("error", 0.5)
    return EBCCConfig(**kw)


def test_nan_rejected():
    data = np.ones((1, 64, 96), np.float32)
    data[0, 3, 4] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        ebcc_tpu.compress(data, small_cfg())


def test_inf_rejected():
    data = np.ones((1, 64, 96), np.float32)
    data[0, 0, 0] = np.inf
    with pytest.raises(ValueError):
        ebcc_tpu.compress(data, small_cfg())


def test_1d_rejected():
    with pytest.raises(ValueError):
        ebcc_tpu.compress(np.ones(100, np.float32), small_cfg())


def test_quantile_mode_rejected():
    with pytest.raises(ValueError, match="QUANTILE"):
        EBCCConfig(mode=ResidualMode.QUANTILE)


def test_container_fuzz_truncations():
    """Truncated/corrupted blobs raise, never crash or mis-decode."""
    data = np.full((1, 64, 96), 7.25, np.float32)  # const: tiny blob
    blob = ebcc_tpu.compress(data, small_cfg())
    for cut in (0, 1, 4, 7, 9, len(blob) - 1):
        try:
            out = ebcc_tpu.decompress(blob[:cut], small_cfg())
        except Exception:
            continue  # clean rejection is fine
        # a truncation that happens to parse must still decode correctly
        np.testing.assert_array_equal(out, data)


def test_blob_roundtrip_many_const_frames():
    data = np.stack([np.full((32, 64), float(i), np.float32)
                     for i in range(5)])
    cfg = small_cfg(max_batch=2)
    blob = ebcc_tpu.compress(data, cfg)
    rec = ebcc_tpu.decompress(blob, cfg)
    np.testing.assert_array_equal(rec, data)
    assert len(blob) < 600  # const shortcut per frame


def test_small_frame_levels_clamped():
    """Frames too small for the configured DWT depth are handled by
    clamping the transform depth (stored in the container), not by a
    shape crash (regression: 16-row frames with base_levels=5 used to
    produce a malformed mirror pad)."""
    rng = np.random.default_rng(0)
    data = rng.normal(100, 5, (1, 16, 48)).astype(np.float32)
    cfg = small_cfg(error=0.5)
    rec = ebcc_tpu.decompress(ebcc_tpu.compress(data, cfg), cfg)
    assert float(np.abs(rec - data).max()) <= 0.5


def test_too_small_frame_rejected():
    with pytest.raises(ValueError, match="4x4"):
        ebcc_tpu.compress(np.ones((1, 2, 64), np.float32), small_cfg())


def test_empty_input_rejected():
    with pytest.raises(ValueError, match="no frames"):
        ebcc_tpu.compress(np.empty((0, 64, 96), np.float32), small_cfg())


def test_negative_values_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.normal(-500.0, 100.0, (1, 64, 96)).astype(np.float32)
    cfg = small_cfg(error=1.0)
    rec = ebcc_tpu.decompress(ebcc_tpu.compress(data, cfg), cfg)
    assert float(np.abs(rec - data).max()) <= 1.0


def test_mixed_geometry_blob_rejected():
    d = np.ones((1, 64, 96), np.float32) * np.linspace(
        0, 10, 64 * 96).reshape(64, 96).astype(np.float32)
    b1 = ebcc_tpu.compress(d, small_cfg(nchunks=4))
    b2 = ebcc_tpu.compress(d, small_cfg(nchunks=8))
    f1 = container.unpack_blob(b1)
    f2 = container.unpack_blob(b2)
    mixed = container.pack_blob([f1[0], f2[0]])
    with pytest.raises(ValueError, match="mixed"):
        ebcc_tpu.decompress(mixed, small_cfg())


def test_infeasible_bound_still_bounded_by_patch():
    """A bound no truncation can meet (pure noise, near-zero target) must
    not crash the bisection search (all-infeasible clamp) and the full
    stream must be taken; DirectCompressor's exact patch then restores the
    hard guarantee."""
    import ebcc_tpu
    from ebcc_tpu import DirectCompressor
    from ebcc_tpu.codec.config import EBCCConfig, ResidualMode
    rng = np.random.default_rng(0)
    data = rng.normal(0, 1000.0, (32, 48)).astype(np.float32)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=1e-5, max_batch=1)
    blob = ebcc_tpu.compress(data, cfg)          # infeasible everywhere
    rec = ebcc_tpu.decompress(blob, cfg)[0]
    assert np.isfinite(rec).all()                # sane full-stream decode
    # with the pointwise wrapper the bound becomes unconditional
    cfgp = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, max_batch=1)
    dc = DirectCompressor(config=cfgp)
    eb = np.full_like(data, 1e-5)
    rec2 = dc.decompress(dc.compress(data, eb))
    assert np.all(np.abs(rec2 - data) <= eb)


def test_cpu_backend_with_prebuilt_codec_rejected():
    """encode_backend='cpu' contradicts a pre-built device codec; the
    combination must fail loudly instead of silently running on device."""
    data = np.ones((1, 128, 128), np.float32)
    cfg = small_cfg(encode_backend="cpu")
    with pytest.raises(ValueError, match="pre-built"):
        ebcc_tpu.compress(data, cfg, codec=object())
