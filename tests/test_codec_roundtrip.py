"""End-to-end codec tests: bound enforcement + compression ratio sanity.

Mirrors the reference's smoke test (test.py:35-59): compress an ERA5-like
frame, decompress, verify the achieved error against the requested bound and
report the compression ratio.
"""

import numpy as np
import pytest

import ebcc_tpu
from ebcc_tpu import EBCCConfig, ResidualMode


def small_cfg(**kw):
    kw.setdefault("max_batch", 2)
    return EBCCConfig(**kw)


def cr(data, blob):
    return data.nbytes / len(blob)


class TestMaxError:
    def test_bound_enforced_small(self, small_frame):
        data = small_frame[None]
        cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=30)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        assert rec.shape == data.shape
        maxerr = float(np.max(np.abs(rec - data)))
        assert maxerr <= 0.5, f"max error {maxerr} > bound"
        assert cr(data, blob) > 3

    def test_tighter_bound_bigger_stream(self, small_frame):
        data = small_frame[None]
        sizes = []
        for e in (2.0, 0.25):
            cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=e)
            blob = ebcc_tpu.compress(data, cfg)
            rec = ebcc_tpu.decompress(blob, cfg)
            assert float(np.max(np.abs(rec - data))) <= e
            sizes.append(len(blob))
        assert sizes[1] > sizes[0]

    def test_very_tight_bound(self, small_frame):
        """Regression: near-lossless bounds force full streams, where the
        smaller-but-infeasible pure-base variant must not be selected
        (api._assemble_frame), and the >15-coded-planes case exercises the
        float32 coefficient fallback path instead of the u16 packing."""
        data = small_frame[None]
        e = 0.0005
        cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=e, base_cr=50)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        assert float(np.max(np.abs(rec - data))) <= e


class TestRelativeError:
    def test_bound_enforced(self, small_frame):
        data = small_frame[None]
        cfg = small_cfg(mode=ResidualMode.RELATIVE_ERROR, error=0.009)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        rng = data.max() - data.min()
        rel = float(np.max(np.abs(rec - data))) / rng
        assert rel <= 0.009


class TestNone:
    def test_rate_targeted(self, small_frame):
        data = small_frame[None]
        cfg = small_cfg(mode=ResidualMode.NONE, base_cr=30)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        assert rec.shape == data.shape
        # stream respects the rate budget (within container overhead)
        assert len(blob) < data.nbytes / 30 + 256
        # and the reconstruction is a sane approximation
        rng = data.max() - data.min()
        assert float(np.max(np.abs(rec - data))) / rng < 0.25


class TestSelfDescribingBlobs:
    def test_decode_with_different_config_defaults(self, small_frame):
        """Frames carry their coder geometry: a blob encoded with one
        nchunks/levels setting must decode correctly under a config with
        different defaults (regression: geometry used to come from the
        decoder's config)."""
        data = small_frame[None]
        enc_cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=0.5,
                            nchunks=4, base_levels=4)
        blob = ebcc_tpu.compress(data, enc_cfg)
        dec_cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=0.5)
        rec = ebcc_tpu.decompress(blob, dec_cfg)
        assert float(np.max(np.abs(rec - data))) <= 0.5


class TestSparsification:
    def test_rate_targeted_with_residual(self, small_frame):
        """SPARSIFICATION_FACTOR: base + rate-budgeted residual layer
        (reference mode 1, j2k_codec.h:556-561)."""
        data = small_frame[None]
        cfg = small_cfg(mode=ResidualMode.SPARSIFICATION_FACTOR, base_cr=60,
                        residual_cr=10)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        # residual layer budget: 8 bits/px / residual_cr, plus base + headers
        assert len(blob) < data.nbytes / 60 + data.size / 10 + 512
        rng = data.max() - data.min()
        base_only = small_cfg(mode=ResidualMode.NONE, base_cr=60)
        rec_base = ebcc_tpu.decompress(ebcc_tpu.compress(data, base_only),
                                       base_only)
        # the residual layer must improve on the base-only reconstruction
        assert (np.abs(rec - data).max() < np.abs(rec_base - data).max())


class TestConstField:
    def test_const(self):
        data = np.full((1, 64, 96), 99.0, np.float32)
        cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=0.1)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        np.testing.assert_array_equal(rec, data)
        assert len(blob) < 128


class TestMultiFrame:
    def test_batch_roundtrip(self, small_frame):
        rng = np.random.default_rng(0)
        data = np.stack([small_frame + rng.normal(0, 0.1)
                         for _ in range(3)]).astype(np.float32)
        cfg = small_cfg(mode=ResidualMode.MAX_ERROR, error=1.0)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        assert rec.shape == data.shape
        assert float(np.max(np.abs(rec - data))) <= 1.0


@pytest.mark.slow
class TestERA5FullFrame:
    def test_relative_error_canonical(self, era5_frame):
        """The reference's canonical config (test.py): rel error 0.009.

        Golden CR threshold: the measured round-5 figure on the real
        fixture (test_data.npy) is 109.1x at this config — >= 100x pins
        it so a rate regression fails CI.  (On the actual temperature.nc
        frame, a rougher field, the same config measures 72.1x vs the
        reference's logged 57.6-62x — docs/PARITY.md.)  The
        synthetic fallback fixture (no /root/reference data) compresses
        differently; it keeps a looser floor.
        """
        data = era5_frame[None]
        cfg = EBCCConfig(mode=ResidualMode.RELATIVE_ERROR, error=0.009,
                         base_cr=100, max_batch=1)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        rng = data.max() - data.min()
        rel = float(np.max(np.abs(rec - data))) / rng
        ratio = cr(data, blob)
        print(f"\nERA5 721x1440 rel-0.009: CR={ratio:.1f}x relerr={rel:.5f}")
        assert rel <= 0.009
        import os
        real_fixture = os.path.exists("/root/reference/data/test_data.npy")
        assert ratio >= (100 if real_fixture else 15)

    def test_max_error_golden_cr(self, era5_frame):
        """Golden CR at the bench config (max_error 0.5): measured ~106x
        on the real fixture; >= 95x pins it against rate regressions."""
        import os
        data = era5_frame[None]
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5,
                         base_cr=100, max_batch=1)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        assert float(np.max(np.abs(rec - data))) <= 0.5
        ratio = cr(data, blob)
        real_fixture = os.path.exists("/root/reference/data/test_data.npy")
        assert ratio >= (95 if real_fixture else 20)

    def test_temperature_nc_parity(self):
        """Canonical-config parity on the reference's ACTUAL canonical
        data (temperature.nc read via h5py — netCDF4 is HDF5-based).
        Round-5 measured 72.1x vs the reference C filter's logged
        57.6-62x per-frame CRs (data/compress_logs.txt); >= 66x pins the
        beats-reference claim with margin for last-ulp drift."""
        import os
        path = "/root/reference/data/temperature.nc"
        if not os.path.exists(path):
            pytest.skip("reference temperature.nc not available")
        h5py = pytest.importorskip("h5py")
        with h5py.File(path, "r") as f:
            data = np.asarray(f["temperature"][0, 0], np.float32)[None]
        cfg = EBCCConfig(mode=ResidualMode.RELATIVE_ERROR, error=0.009,
                         base_cr=100, max_batch=1)
        blob = ebcc_tpu.compress(data, cfg)
        rec = ebcc_tpu.decompress(blob, cfg)
        rng = data.max() - data.min()
        assert float(np.max(np.abs(rec - data))) / rng <= 0.009
        assert cr(data, blob) >= 66
