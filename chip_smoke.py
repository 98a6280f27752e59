"""Smoke test of the error-bounded encode/decode path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: every single-card phase
    python chip_smoke.py --cards 4    # four GPUs: the sharded paths only

Single-card phases, each printing one line:

* env      -- nvidia-smi name and power limit, JAX version and device;
* native   -- rebuilds the host library from the committed sources
              (set-up time), its coder path;
* main     -- ``ebcc_tpu.compress`` / ``decompress`` of 32 seeded 721x1440
              frames at max error 0.5 on the device: compile seconds,
              warm encode/decode seconds, CR, achieved max error, peak
              device memory;
* cross    -- the same blob through the native CPU decoder (the path HDF5
              readers take), and whether the first two frames' containers
              are byte-identical to the native CPU encoder's (a finding,
              not a check);
* pointwise -- ``DirectCompressor`` on 4 frames with a per-point bound;
* cli      -- ``ebcc_tpu.cli.main`` compress + decompress of a 2-frame .npy;
* trace    -- one profiler trace of a warm batch-16 device encode: device
              time of the truncation bisections, the chunk-mask scans and
              the residual layer plus packings, their share of device
              encode time, and the device busy share over the window.

With ``--cards 4``: the frame-sharded compress on a 4x1 (data) mesh and the
spatially-sharded encode on a 1x4 (space) mesh, each with the bound checked
and its truncation choices compared with the single-card codec's.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises, so the script exits non-zero without that line; it does the same
when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 721, 1440
ERROR = 0.5
QBASE = 1e-6
N_MAIN, BATCH = 32, 16


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class CompileClock:
    """Seconds and count of XLA backend compilations, from JAX's
    monitoring events (one listener per process)."""

    def __init__(self):
        import jax
        self.seconds, self.count = 0.0, 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
            self.count += 1


def max_config(batch: int, **kw):
    from ebcc_tpu import EBCCConfig, ResidualMode
    return EBCCConfig(mode=ResidualMode.MAX_ERROR, error=ERROR, base_cr=100,
                      max_batch=batch, **kw)


def phase_native() -> None:
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"), "clean"],
                   check=True, capture_output=True)
    from ebcc_tpu.runtime import native  # rebuilds the cleaned library
    if not native.HAVE_NATIVE:
        raise RuntimeError("native build failed:\n" +
                           (native.BUILD_ERROR or ""))
    log("native", build_s=f"{native.LAST_BUILD_S:.1f}", have_native=True,
        coder=native.coder_path())


def phase_main(clock, data, batch):
    import jax

    import ebcc_tpu
    cfg = max_config(batch, encode_backend="device", decode_backend="device")
    c0 = clock.seconds
    t0 = time.perf_counter()
    blob = ebcc_tpu.compress(data, cfg)
    rec = ebcc_tpu.decompress(blob, cfg)
    first_s = time.perf_counter() - t0
    compile_s, n_compiles = clock.seconds - c0, clock.count
    t0 = time.perf_counter()
    blob = ebcc_tpu.compress(data, cfg)
    t1 = time.perf_counter()
    rec = ebcc_tpu.decompress(blob, cfg)
    t2 = time.perf_counter()
    check(clock.count == n_compiles, "warm calls compiled again")
    check(rec.shape == data.shape and np.isfinite(rec).all(),
          f"bad reconstruction {rec.shape}")
    err = float(np.max(np.abs(rec - data)))
    check(err <= ERROR, f"device round trip max error {err} > {ERROR}")
    stats = jax.devices()[0].memory_stats() or {}
    log("main", frames=data.shape[0], batch=batch,
        compile_s=f"{compile_s:.1f}", first_call_s=f"{first_s:.1f}",
        encode_s=f"{t1 - t0:.3f}", decode_s=f"{t2 - t1:.3f}",
        cr=f"{data.nbytes / len(blob):.2f}", max_err=f"{err:.4f}",
        peak_bytes=stats.get("peak_bytes_in_use", "n/a"))
    return blob


def phase_cross(blob, data, batch) -> None:
    import ebcc_tpu
    from ebcc_tpu.codec import container
    rec = ebcc_tpu.decompress(blob, max_config(batch, decode_backend="cpu"))
    err = float(np.max(np.abs(rec - data)))
    check(err <= ERROR, f"native decode of the device blob: {err}")
    cpu_blob = ebcc_tpu.compress(data[:2],
                                 max_config(batch, encode_backend="cpu"))
    same = (container.unpack_blob(blob)[:2] ==
            container.unpack_blob(cpu_blob))
    log("cross", native_decode_max_err=f"{err:.4f}",
        first2_byte_identical_to_cpu_encoder=same)


def phase_pointwise(data) -> None:
    from ebcc_tpu import DirectCompressor
    rng = np.random.default_rng(1)
    eb = (0.2 + 0.4 * rng.random(data.shape)).astype(np.float32)
    dc = DirectCompressor()
    blob = dc.compress(data, eb)
    rec = dc.decompress(blob)
    bad = int(np.sum(np.abs(rec - data) > eb))
    check(bad == 0, f"pointwise bound violated at {bad} points")
    log("pointwise", frames=data.shape[0], points=data.size,
        violations=bad, cr=f"{data.nbytes / len(blob):.2f}")


def phase_cli(data) -> None:
    from ebcc_tpu import cli
    with tempfile.TemporaryDirectory() as tmp:
        src, enc, dec = (os.path.join(tmp, n)
                         for n in ("in.npy", "out.ebt", "rec.npy"))
        np.save(src, data)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["compress", src, enc, "--mode", "max_error",
                      "--error", str(ERROR), "--base-cr", "100"])
            cli.main(["decompress", enc, dec])
        rec = np.load(dec)
    err = float(np.max(np.abs(rec - data)))
    check(rec.shape == data.shape, f"cli shape {rec.shape}")
    check(err <= ERROR, f"cli round trip max error {err}")
    cr = json.loads(out.getvalue().splitlines()[0])["cr"]
    log("cli", frames=data.shape[0], cr=f"{cr:.2f}", max_err=f"{err:.4f}")


def phase_trace(data, batch, trace_dir) -> dict:
    """Device time of one warm hostq encode, per named pipeline stage."""
    import jax
    import jax.numpy as jnp

    from ebcc_tpu import api
    from ebcc_tpu.codec.pipeline import SCOPES
    from ebcc_tpu.utils import profiling

    cfg = max_config(batch)
    codec = api._codec_for(data.shape[1], data.shape[2], cfg)
    u, mn, mx, maxq = api._scale_u16_host(data[:batch])
    args = (jnp.asarray(u), jnp.asarray(mn), jnp.asarray(mx),
            jnp.asarray(np.full(batch, ERROR, np.float32) - maxq),
            jnp.float32(QBASE))
    fn = codec._encode_eb_hostq
    jax.block_until_ready(fn(*args))  # warm
    names = profiling.hlo_scopes(fn.lower(*args).compile().as_text(), SCOPES)
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation("ebcc_encode_window"):
            jax.block_until_ready(fn(*args))
    red = profiling.device_time_by_scope(profiling.load_trace(trace_dir),
                                         names, window="ebcc_encode_window")
    check(red["n_events"] > 0, "no device kernels in the traced window")
    k = red["kernel_ns"]
    fields = {f"{sc}_ms": f"{red['by_scope'].get(sc, 0.0) / 1e6:.3f}"
              for sc in SCOPES}
    fields.update({f"{sc}_share": f"{red['by_scope'].get(sc, 0.0) / k:.3f}"
                   for sc in SCOPES})
    log("trace", batch=batch, kernels=red["n_events"],
        device_encode_ms=f"{k / 1e6:.3f}", **fields,
        other_share=f"{red['unattributed_ns'] / k:.3f}",
        window_ms=f"{red['window_ns'] / 1e6:.3f}",
        busy_share=f"{red['busy_ns'] / max(red['window_ns'], 1.0):.3f}")
    return red


CHOICE_FIELDS = ("bs_q", "ks_q", "km_q")
# truncation choices.  The coefficients behind them may differ: on XLA:GPU
# the row-sharded frame mean reduces in another order, so where the mean
# lies within rounding of an integer its floor (the DC offset) moves by one
# and shifts the coarsest band
SPATIAL_FIELDS = ("bs_q", "ks_q", "km_q", "bs_pure", "ks_pure", "km_pure",
                  "base_feasible_pure", "skip_residual")


def _devices_of(x) -> set:
    return {s.device for s in x.addressable_shards}


def phase_sharded(data, cards: int) -> None:
    """Frame-sharded compress on a (cards x 1) mesh and spatially-sharded
    encode on a (1 x cards) mesh; choices equal the single-card codec's."""
    import jax
    import jax.numpy as jnp

    import ebcc_tpu
    from ebcc_tpu import api
    from ebcc_tpu.codec.pipeline import FrameCodec
    from ebcc_tpu.parallel import batch as pbatch
    from ebcc_tpu.parallel.mesh import frame_sharding, make_mesh
    from ebcc_tpu.parallel.spatial import SpatialShardedCodec

    n, h, w = data.shape
    cfg = max_config(n)
    target = np.full(n, ERROR, np.float32)
    dense = FrameCodec(h, w, cfg).encode_error_bounded(
        jnp.asarray(data), target, jnp.float32(QBASE))

    mesh = make_mesh(n_data=cards, n_space=1)
    spread = _devices_of(jax.device_put(data, frame_sharding(mesh)))
    check(len(spread) == cards, f"data mesh spans {len(spread)} devices")
    blob = pbatch.compress_sharded(data, cfg, mesh=mesh)
    rec = ebcc_tpu.decompress(blob, max_config(n, decode_backend="device"))
    err = float(np.max(np.abs(rec - data)))
    check(err <= ERROR, f"sharded compress max error {err}")
    res = pbatch.sharded_codec(h, w, cfg, mesh).encode_error_bounded(
        data, target, QBASE)
    check(len(_devices_of(res.base_coef)) == cards,
          "sharded result not spread over the mesh")
    for f in CHOICE_FIELDS:
        check(np.array_equal(np.asarray(getattr(res, f)),
                             np.asarray(getattr(dense, f))),
              f"data-sharded {f} differs from the single-card codec")
    log("sharded_data", mesh=f"{cards}x1", frames=n,
        devices=sorted(d.id for d in spread), max_err=f"{err:.4f}",
        cr=f"{data.nbytes / len(blob):.2f}", choices_equal=True)

    spc = SpatialShardedCodec(h, w, cfg, make_mesh(n_data=1, n_space=cards))
    sp = spc.encode_error_bounded(data, target, QBASE)
    check(len(_devices_of(sp.base_coef)) == cards,
          "spatial result not spread over the mesh")
    frames_differing = {f: int(np.sum(np.asarray(getattr(sp, f)) !=
                                      np.asarray(getattr(dense, f))))
                        for f in SPATIAL_FIELDS}
    blob = api.compress(data, cfg, codec=spc)
    rec = ebcc_tpu.decompress(blob, max_config(n, decode_backend="device"))
    err = float(np.max(np.abs(rec - data)))
    dcoef = np.abs(np.asarray(sp.base_coef) - np.asarray(dense.base_coef))
    log("sharded_space", mesh=f"1x{cards}", frames=n, size=f"{h}x{w}",
        max_err=f"{err:.4f}", cr=f"{data.nbytes / len(blob):.2f}",
        base_coef_differing=int((dcoef > 0).sum()),
        base_coef_max_diff=float(dcoef.max()),
        frames_differing=json.dumps(frames_differing).replace(" ", ""))
    check(err <= ERROR, f"spatial compress max error {err}")
    for f, k in frames_differing.items():
        check(k == 0, f"space-sharded {f} differs from the single-card "
                      f"codec in {k} frames")


def require_gpu_devices(devices, cards: int) -> None:
    """Exit non-zero, before any work, unless JAX sees ``cards`` GPUs.
    Decided on JAX alone: importing ``ebcc_tpu`` would load the native
    library that the native phase cleans and rebuilds."""
    if devices[0].platform != "gpu" or len(devices) < cards:
        raise SystemExit(f"chip_smoke: needs {cards} GPU(s); JAX found "
                         f"{len(devices)} {devices[0].platform} device(s)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    p.add_argument("--trace-dir", default=None,
                   help="keep the profiler trace here (default: a "
                        "temporary directory)")
    args = p.parse_args(argv)

    import jax
    require_gpu_devices(jax.devices(), args.cards)
    phase_native()
    from ebcc_tpu.dataprep import synthetic_frames
    from ebcc_tpu.utils import device
    from ebcc_tpu.utils.compile_cache import enable_compile_cache

    info = device.device_info(jax.devices())
    card = device.nvidia_smi_line()
    _, watts = device.parse_nvidia_smi(card)  # raises on a malformed line
    print(f"card: {card}", flush=True)
    cache = enable_compile_cache()
    log("env", jax=jax.__version__, platform=info["platform"],
        kind=repr(info["kind"]), count=info["count"], power_limit_w=watts,
        compile_cache=cache,
        cache_warm=os.path.isdir(cache) and bool(os.listdir(cache)))
    clock = CompileClock()

    if args.cards > 1:
        phase_sharded(synthetic_frames(BATCH, H, W, sigma=0.05, seed=0),
                      args.cards)
    else:
        data = synthetic_frames(N_MAIN, H, W, sigma=0.05, seed=0)
        blob = phase_main(clock, data, BATCH)
        phase_cross(blob, data, BATCH)
        phase_pointwise(data[:4])
        phase_cli(data[:2])
        with contextlib.ExitStack() as stack:
            tdir = args.trace_dir or stack.enter_context(
                tempfile.TemporaryDirectory())
            phase_trace(data, BATCH, tdir)
    print(device.result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
