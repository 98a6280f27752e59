"""Benchmark: compress+decompress throughput at a fixed max-error bound.

Needs a GPU: it fails when JAX finds none.  Prints the device (JAX
platform, device kind and count, nvidia-smi name and power limit) and then
ONE JSON line:
  {"metric": ..., "value": N, "unit": "grid-points/s", "vs_baseline": N}

Baseline: the reference C filter is single-threaded per chunk and performs
~6-9 full OpenJPEG encode+decode probes plus ~15 SPIHT decode probes per
frame for the error-bound search (BASELINE.md; data/compress_logs.txt:7-29).
No throughput number is recorded in the reference repo, so the baseline here
is a *generous* estimate of 2.0e6 grid-points/s for single-core C
compress+decompress at these settings (OpenJPEG alone encodes ~5-20 Mpx/s
single-core; with ~8 re-encode probes + SPIHT passes the pipeline lands at
1-3 Mpx/s).
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_GRID_POINTS_PER_S = 2.0e6
H, W = 721, 1440


def main():
    import jax
    import jax.numpy as jnp

    from ebcc_tpu.utils import device
    from ebcc_tpu.utils.compile_cache import enable_compile_cache

    info = device.require_gpu()
    print(f"device: {device.nvidia_smi_line()}; jax {jax.__version__} "
          f"platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}")
    enable_compile_cache()

    import ebcc_tpu
    from ebcc_tpu import EBCCConfig, ResidualMode
    from ebcc_tpu import api as _api
    from ebcc_tpu.dataprep import synthetic_frames

    frames_per_batch = int(os.environ.get("EBCC_BENCH_BATCH", "16"))
    n_frames = 2 * frames_per_batch
    data = synthetic_frames(n_frames, H, W, sigma=0.05, seed=0)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                     max_batch=frames_per_batch, encode_backend="device",
                     decode_backend="device")

    # warmup: compile both directions
    blob = ebcc_tpu.compress(data[:frames_per_batch], cfg)
    rec = ebcc_tpu.decompress(blob, cfg)

    # best single run of 3 repetitions (one run's enc+dec together, not a
    # best-enc/best-dec composite no run achieved); both calls return host
    # arrays, so the clock stops after the device work is done
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        blob = ebcc_tpu.compress(data, cfg)
        t1 = time.perf_counter()
        rec = ebcc_tpu.decompress(blob, cfg)
        t2 = time.perf_counter()
        if best is None or t2 - t0 < best[0]:
            best = (t2 - t0, t1 - t0, t2 - t1)
    total, enc_s, dec_s = best

    # device-compute-only throughput of the encode analysis (transform +
    # embedded-coder truncation search): the hostq entry api.compress
    # dispatches, with its u16 input already resident on the device
    codec = _api._codec_for(H, W, cfg)
    u, mnb, mxb, maxq = _api._scale_u16_host(data[:frames_per_batch])
    dev_u = jnp.asarray(u)
    dev_mn, dev_mx = jnp.asarray(mnb), jnp.asarray(mxb)
    target = jnp.asarray(np.full(frames_per_batch, 0.5, np.float32) - maxq)
    jax.block_until_ready(codec.encode_error_bounded_hostq(
        dev_u, dev_mn, dev_mx, target, 1e-6))
    dev_best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(codec.encode_error_bounded_hostq(
            dev_u, dev_mn, dev_mx, target, 1e-6))
        dev_best = min(dev_best, time.perf_counter() - t0)
    dev_pts_per_s = frames_per_batch * H * W / dev_best

    maxerr = float(np.max(np.abs(rec - data)))
    assert maxerr <= 0.5, f"bound violated: {maxerr}"
    cr = data.nbytes / len(blob)
    value = data.size / total
    print(json.dumps({
        "metric": "compress+decompress grid-points/s @ max_error=0.5 "
                  f"(synthetic {H}x{W}, {n_frames} frames, CR={cr:.1f}x, "
                  f"maxerr={maxerr:.3f}, enc={enc_s:.2f}s, dec={dec_s:.2f}s"
                  f"; device-only encode {dev_pts_per_s / 1e6:.1f}M pts/s)",
        "value": round(value, 1),
        "unit": "grid-points/s",
        "vs_baseline": round(value / BASELINE_GRID_POINTS_PER_S, 3),
        "device_encode_pts_per_s": round(dev_pts_per_s, 1),
        "wall_encode_s": round(enc_s, 3),
        "wall_decode_s": round(dec_s, 3),
        "cr": round(cr, 2),
        "device": info,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
