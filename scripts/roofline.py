"""On-device roofline accounting for the v4 encode pipeline (needs a
GPU; fails without one).

Grounds the "fraction of roofline" statement in SAME-CHIP measurements
instead of spec-sheet numbers:

1. practical stream bandwidth: best-of-N of a 2-read/1-write elementwise
   pass over a base-geometry f32 plane (the shape every recon eval
   touches), bytes / best-seconds;
2. one inverse transform (idwt2d_multi, base geometry);
3. one full recon eval (recon_masked + weighted IDWT + crop/unscale +
   error reduction) — the unit the truncation bisections and the mask
   greedy scans are made of;
4. the minimal traffic a perfectly-fused eval would move (read ci.i32 +
   read data.f32 + tiny outputs), for the headroom column.

Prints one JSON dict, naming the device.  Device work is timed up to
``jax.block_until_ready``.  Run:  python scripts/roofline.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def best_of(fn, sync, reps=5):
    sync(fn())  # warm/compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from ebcc_tpu import EBCCConfig, ResidualMode, api
    from ebcc_tpu.codec.pipeline import FrameCodec
    from ebcc_tpu.dataprep import synthetic_frames
    from ebcc_tpu.ops import bitplane as bp
    from ebcc_tpu.ops import dwt
    from ebcc_tpu.utils import device
    from ebcc_tpu.utils.compile_cache import enable_compile_cache

    info = device.require_gpu()
    enable_compile_cache()
    B, H, W = int(os.environ.get("EBCC_BENCH_BATCH", "8")), 721, 1440
    rng = np.random.default_rng(0)
    data = synthetic_frames(B, H, W, sigma=0.05, seed=0)

    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                     max_batch=B)
    c = FrameCodec(H, W, cfg)
    hp, wp = c.base.hp, c.base.wp
    out = {"device": info, "card": device.nvidia_smi_line(),
           "batch": B, "hp": hp, "wp": wp}
    sync = jax.block_until_ready

    # each quantity is the DELTA between an N-iteration and a 1-iteration
    # in-program loop, so dispatch and launch overheads cancel
    NIT = 9

    def loop_time(step, x0, n):
        f = jax.jit(lambda x: jax.lax.fori_loop(
            0, n, lambda i, v: step(v, i), x0, unroll=False))
        return best_of(lambda: f(x0), sync)

    # ---- 1. practical stream bandwidth ----
    xs = jnp.asarray(rng.standard_normal((B, hp, wp)).astype(np.float32))
    ys = jnp.asarray(rng.standard_normal((B, hp, wp)).astype(np.float32))
    t1 = loop_time(lambda v, i: v * 1.0001 + ys, xs, 1)
    tn = loop_time(lambda v, i: v * 1.0001 + ys, xs, NIT)
    t = max((tn - t1) / (NIT - 1), 1e-9)
    bytes_stream = 3 * xs.nbytes  # 2 reads + 1 write
    out["stream_pass_s"] = t
    out["stream_gbps"] = bytes_stream / t / 1e9

    # ---- 2. one inverse transform at base geometry ----
    t1 = loop_time(lambda v, i: dwt.idwt2d_multi(v, c.base.levels), xs, 1)
    tn = loop_time(lambda v, i: dwt.idwt2d_multi(v, c.base.levels), xs, NIT)
    t = max((tn - t1) / (NIT - 1), 1e-9)
    out["idwt_s"] = t
    out["idwt_eff_gbps_min_traffic"] = 2 * xs.nbytes / t / 1e9

    # ---- 3. one full recon eval (the search unit) ----
    u, mnb, mxb, maxq = api._scale_u16_host(data)
    du = jnp.asarray(u)
    dmn, dmx = jnp.asarray(mnb), jnp.asarray(mxb)
    tgt = jnp.asarray(np.full(B, 0.5, np.float32) - maxq)

    def evals(n):
        def fn(u, mn, mx, tgt):
            dataq, const, dc, ci = c._hostq_prelude(u, mn, mx)
            an = bp.analyze(ci, c.base.spec)

            def body(i, acc):
                bsv = jnp.full(B, 3, jnp.int32) + (i % 5)
                drop = (jnp.zeros((B, c.base.spec.nchunks), bool)
                        .at[:, i % c.base.spec.nchunks].set(True))
                rec = bp.recon_masked(an, bsv, drop, c.base.spec)
                err = jnp.abs(dataq - c._base_recon(rec, mn, mx, dc)) - \
                    tgt[:, None, None]
                return (acc + jnp.sum(jnp.max(err, axis=(-2, -1))) +
                        jnp.sum(jnp.mean(err > 0, axis=(-2, -1))))

            return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

        return jax.jit(fn)

    f1, fn_ = evals(1), evals(NIT)
    t1 = best_of(lambda: f1(du, dmn, dmx, tgt), sync)
    tn = best_of(lambda: fn_(du, dmn, dmx, tgt), sync)
    t_eval = max((tn - t1) / (NIT - 1), 1e-9)
    out["recon_eval_s"] = t_eval

    # minimal fused-eval traffic: ci int32 + dataq f32 once each, outputs
    # negligible (per-frame scalars)
    min_bytes = B * hp * wp * 4 + B * H * W * 4
    out["recon_eval_min_bytes"] = min_bytes
    out["recon_eval_eff_gbps_min_traffic"] = min_bytes / t_eval / 1e9
    out["recon_eval_headroom_x"] = (
        out["stream_gbps"] / out["recon_eval_eff_gbps_min_traffic"])

    print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
