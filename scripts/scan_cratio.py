"""CR-scan benchmark: rate-optimiser quality + throughput.

Parity with /root/reference/scripts/scan_cratio/scan_cratio_single_level.py:
scan candidate rate knobs, record achieved CR and MB/s throughput for the
optimiser and for fixed configs, and write a CSV consumed by the plotting
script.
"""

import argparse
import csv
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--out", default="scan_cratio.csv")
    args = p.parse_args()

    if args.input:
        data = np.load(args.input).astype(np.float32)
    elif os.path.exists("/root/reference/data/test_data.npy"):
        data = np.load("/root/reference/data/test_data.npy").astype(
            np.float32)
    else:
        y, x = np.mgrid[0:721, 0:1440]
        data = (260 + 25 * np.sin(y / 721 * np.pi) *
                np.cos(x / 1440 * 2 * np.pi)).astype(np.float32)

    # the MB/s column is a device figure: refuse to run without a GPU
    from ebcc_tpu.utils import device
    from ebcc_tpu.utils.compile_cache import enable_compile_cache
    info = device.require_gpu()
    print(f"device: {device.nvidia_smi_line()}; {info}", file=sys.stderr)
    # persistent compilation cache: the multi-q optimiser program is a
    # multi-minute compile at full frame size; repeat runs skip it
    enable_compile_cache()

    from ebcc_tpu import EBCCConfig, RateOptimizedCompressor, ResidualMode
    from ebcc_tpu import compress, decompress

    rows = []
    # fixed-quantile configs (the scan axis)
    for q in (0.0, 1e-6, 1e-5, 1e-4, 1e-3):
        os.environ["EBCC_INIT_BASE_ERROR_QUANTILE"] = repr(q)
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=args.error)
        t0 = time.perf_counter()
        blob = compress(data, cfg)
        dt = time.perf_counter() - t0
        rec = decompress(blob, cfg).reshape(data.shape)
        rows.append(dict(method=f"fixed_q={q:g}", cr=data.nbytes / len(blob),
                         max_error=float(np.abs(rec - data).max()),
                         mbps=data.nbytes / dt / 1e6))
        print(json.dumps(rows[-1]))
    os.environ.pop("EBCC_INIT_BASE_ERROR_QUANTILE", None)

    # the optimiser (golden-section-search equivalent)
    ro = RateOptimizedCompressor(
        EBCCConfig(mode=ResidualMode.MAX_ERROR, error=args.error))
    t0 = time.perf_counter()
    blob, info = ro.compress(data)
    dt = time.perf_counter() - t0
    rec = ro.decompress(blob).reshape(data.shape)
    rows.append(dict(method=f"optimized(q={info['best_quantile']:g})",
                     cr=info["cr"],
                     max_error=float(np.abs(rec - data).max()),
                     mbps=data.nbytes / dt / 1e6))
    print(json.dumps(rows[-1]))

    with open(args.out, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0]))
        wr.writeheader()
        wr.writerows(rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
