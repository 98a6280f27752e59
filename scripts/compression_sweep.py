"""Compression sweep: lossless baselines vs EBCC-TPU error-bound grid.

Equivalent of the reference's scripts/hdf5_compression_sweep.py:
runs gzip/lzf lossless baselines (:87-94 there) and an EBCC max-error sweep
(:118-170) over a stack of frames, writing one CSV.  Where the reference
fans out with multiprocessing.Pool, the sweep here batches all frames into
one device dispatch per bound.

Usage:
    python scripts/compression_sweep.py INPUT.npy --errors 0.1 0.5 1.0 \
        --out sweep.csv
"""

import argparse
import csv
import json
import time

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lossless_baselines(data: np.ndarray):
    """gzip/lzf-style lossless baselines via zlib / zstd."""
    import zlib
    rows = []
    raw = data.tobytes()
    for name, fn in [
        ("zlib-6", lambda b: zlib.compress(b, 6)),
        ("zlib-9", lambda b: zlib.compress(b, 9)),
    ]:
        t0 = time.perf_counter()
        blob = fn(raw)
        rows.append(dict(method=name, error_target=0.0,
                         cr=len(raw) / len(blob), max_error=0.0,
                         rmse=0.0, encode_s=time.perf_counter() - t0,
                         decode_s=0.0))
    try:
        import zstandard as zstd
        t0 = time.perf_counter()
        blob = zstd.ZstdCompressor(level=9).compress(raw)
        rows.append(dict(method="zstd-9", error_target=0.0,
                         cr=len(raw) / len(blob), max_error=0.0,
                         rmse=0.0, encode_s=time.perf_counter() - t0,
                         decode_s=0.0))
    except ImportError:
        pass
    return rows


def ebcc_sweep(data: np.ndarray, errors, mode: str, base_cr: float):
    import ebcc_tpu
    from ebcc_tpu import EBCCConfig, ResidualMode
    m = ResidualMode[mode.upper()]
    rows = []
    for err in errors:
        cfg = EBCCConfig(mode=m, error=err, base_cr=base_cr)
        t0 = time.perf_counter()
        blob = ebcc_tpu.compress(data, cfg)
        enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = ebcc_tpu.decompress(blob, cfg).reshape(data.shape)
        dec = time.perf_counter() - t0
        diff = np.abs(rec - data)
        rows.append(dict(method=f"ebcc-{mode}", error_target=err,
                         cr=data.nbytes / len(blob),
                         max_error=float(diff.max()),
                         rmse=float(np.sqrt(np.mean(diff ** 2))),
                         encode_s=enc, decode_s=dec))
        print(json.dumps(rows[-1]))
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("--errors", type=float, nargs="+",
                   default=[0.1, 0.5, 1.0, 2.0])
    p.add_argument("--mode", default="max_error",
                   choices=["max_error", "relative_error"])
    p.add_argument("--base-cr", type=float, default=100.0)
    p.add_argument("--out", default="sweep.csv")
    p.add_argument("--resume", action="store_true",
                   help="skip (method, error_target) rows already in --out")
    args = p.parse_args()

    data = np.load(args.input).astype(np.float32)

    # incremental, resumable output (the reference's sweep drivers write
    # per-finished-task; idempotent restarts via skip-if-done)
    done = set()
    resumable = False
    if args.resume and os.path.exists(args.out):
        with open(args.out, newline="") as f:
            rd = csv.DictReader(f)
            if rd.fieldnames and "method" in rd.fieldnames:
                resumable = True
                for row in rd:
                    try:
                        done.add((row["method"],
                                  float(row["error_target"])))
                    except (TypeError, ValueError):
                        continue  # partially flushed last line
    fields = ["method", "error_target", "cr", "max_error", "rmse",
              "encode_s", "decode_s"]
    mode_new = not resumable
    out_f = open(args.out, "w" if mode_new else "a", newline="")
    wr = csv.DictWriter(out_f, fieldnames=fields, extrasaction="ignore")
    if mode_new:
        wr.writeheader()

    def emit(row):
        wr.writerow(row)
        out_f.flush()

    for row in lossless_baselines(data):
        if (row["method"], row["error_target"]) not in done:
            emit(row)
    for err in args.errors:
        if (f"ebcc-{args.mode}", err) in done:
            continue
        for row in ebcc_sweep(data, [err], args.mode, args.base_cr):
            emit(row)
    out_f.close()
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
