"""Micro-benchmark of the device-side transform stages on a GPU (fails
without one): DWT/IDWT, plane-scan iteration, full encode split.  One IDWT
of [8,768,1472] f32 touches ~0.1-1 GB depending on fusion.  Prints the
device, then a JSON dict of stage -> best seconds."""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from ebcc_tpu.ops import bitplane as bp
    from ebcc_tpu.ops import dwt
    from ebcc_tpu.utils import device
    from ebcc_tpu.utils.compile_cache import enable_compile_cache

    info = device.require_gpu()
    print(f"device: {device.nvidia_smi_line()}; {info}", file=sys.stderr)
    enable_compile_cache()

    B, H, W = 8, 768, 1472
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (B, H, W)).astype(np.float32))
    t = {}

    f_dwt = jax.jit(lambda v: dwt.dwt2d_multi(v, 5))
    f_idwt = jax.jit(lambda v: dwt.idwt2d_multi(v, 5))
    t["dwt5"] = timeit(f_dwt, x)
    t["idwt5"] = timeit(f_idwt, x)

    # one plane-scan iteration: recon_truncated + idwt + err stats
    spec = bp.CoderSpec(height=H, width=W, group_levels=6, nplanes=22)
    ci = jnp.asarray((rng.laplace(0, 100, (B, H, W))).astype(np.int32))
    an = bp.analyze(ci, spec)
    data = x

    @jax.jit
    def scan_iter(an, b):
        rec = bp.recon_truncated(an, b)
        err = jnp.abs(data - dwt.idwt2d_multi(rec, 5))
        return jnp.max(err, axis=(-2, -1)), jnp.mean(err > 0, axis=(-2, -1))

    t["scan_iter"] = timeit(scan_iter, an, jnp.full((B,), 8, jnp.int32))
    t["analyze"] = timeit(jax.jit(lambda c: bp.analyze(c, spec)), ci)
    t["segment_counts"] = timeit(
        jax.jit(lambda a: bp.segment_counts(a, spec)), an)

    per_batch_ideal = (22 + 8) * t["scan_iter"] + t["dwt5"] * 2
    t["est_base_search"] = per_batch_ideal
    print(json.dumps({k: round(v, 4) for k, v in t.items()}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
