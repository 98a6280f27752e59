"""Weak-scaling benchmark over a device mesh.

Evidence for the multi-device scaling story (BASELINE.md north star: >= 85%
scaling efficiency): compress a stack of B = frames_per_device * N frames on
an N-device mesh and report grid-points/s and efficiency vs N=1.

CAVEAT: on a single-host CPU run the N "devices" are virtual and share the
host's physical cores, so reported efficiency measures the host's compute
capacity, NOT the partitioning quality — on this repo's 1-core dev host the
numbers are meaningless beyond "the sharded program runs".  Run on a real
pod slice for real scaling numbers.

    python scripts/scaling_bench.py --devices 1 2 4 8 --frames-per-device 2
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_procs_mode(args):
    """Cross-PROCESS scaling row: the same sharded encode through
    scripts/launch_multihost.py at 1 and N processes (jax.distributed,
    collectives crossing the process boundary).  This is the honest
    maximum scaling artifact this 1-chip/1-core environment can produce —
    on a shared-core host the efficiency number measures core contention,
    not partitioning quality (same caveat as the virtual mesh)."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    launcher = os.path.join(here, "launch_multihost.py")
    rows = []
    for nproc in args.procs:
        cmd = [sys.executable, launcher, "--local", str(nproc),
               "--devices-per-proc", "1",
               "--frames", str(args.frames_per_device * max(args.procs)),
               "--size", str(args.size[0]), str(args.size[1]),
               "--error", str(args.error)]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=1800)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("{")]
        if r.returncode != 0 or not line:
            print(json.dumps({"processes": nproc, "error":
                              (r.stderr or "no output")[-300:]}))
            continue
        rows.append(json.loads(line[-1]))
        print(json.dumps(rows[-1]))
    if len(rows) >= 2:
        base = rows[0]["grid_points_per_s"] / rows[0]["processes"]
        for row in rows[1:]:
            eff = row["grid_points_per_s"] / (base * row["processes"])
            print(json.dumps({
                "scaling": f"{rows[0]['processes']}->"
                           f"{row['processes']} processes",
                "efficiency": round(eff, 3),
                "caveat": "virtual CPU mesh on a shared-core host: "
                          "measures core contention, not partitioning",
            }))
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--frames-per-device", type=int, default=2)
    p.add_argument("--size", type=int, nargs=2, default=[721, 1440])
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--force-cpu-mesh", action="store_true",
                   help="run on a virtual CPU mesh (for hosts with 1 chip)")
    p.add_argument("--procs", type=int, nargs="+", default=None,
                   help="cross-process mode: run launch_multihost.py at "
                        "each N and report the scaling row")
    args = p.parse_args()

    if args.procs:
        return run_procs_mode(args)

    if args.force_cpu_mesh:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        n = max(args.devices)
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={n}").strip()

    import jax
    if len(jax.devices()) < max(args.devices):
        p.error(f"only {len(jax.devices())} device(s) available; pass "
                "--force-cpu-mesh to run on a virtual CPU mesh")
    import numpy as np

    from ebcc_tpu import EBCCConfig, ResidualMode
    from ebcc_tpu.parallel.batch import ShardedCodec
    from ebcc_tpu.parallel.mesh import make_mesh

    h, w = args.size
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)

    results = []
    base_tp = None
    for nd in args.devices:
        b = nd * args.frames_per_device
        data = np.stack([base + rng.normal(0, 0.05, (h, w))
                         .astype(np.float32) for _ in range(b)])
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=args.error,
                         max_batch=b)
        mesh = make_mesh(n_data=nd, n_space=1,
                         devices=jax.devices()[:nd])
        sc = ShardedCodec(h, w, cfg, mesh=mesh)
        target = np.full(b, args.error, np.float32)
        res = sc.encode_error_bounded(data, target, 1e-6)  # compile
        jax.block_until_ready(res)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            res = sc.encode_error_bounded(data, target, 1e-6)
            jax.block_until_ready(res)
            best = min(best, time.perf_counter() - t0)
        tp = data.size / best
        if base_tp is None:
            base_tp = tp / nd
        results.append(dict(devices=nd, frames=b, seconds=best,
                            grid_points_per_s=tp,
                            efficiency=tp / (base_tp * nd)))
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    main()
