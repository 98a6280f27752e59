"""Multi-host launcher: start an N-process jax.distributed compression run.

The L6 infrastructure layer (reference analogue: the SLURM scripts,
/root/reference/scripts/launch_hdf5_compression_sweep.sbatch — which only
ran INDEPENDENT single-node jobs; this launcher instead joins N processes
into one JAX runtime with a mesh spanning them).

Two modes:

* ``--local N``: spawn N worker processes on this machine (each with
  ``--devices-per-proc`` virtual CPU devices) — the laptop/CI analogue of
  an N-host pod.
* under SLURM (see launch_multihost.sbatch): every task runs this script
  with ``--from-slurm``; coordinator = task 0's host.

Each worker compresses its share of the input frames through the batched
codec on a global (data x space) mesh and reports throughput; worker 0
verifies the bound on its shard.

    python scripts/launch_multihost.py --local 2 --frames 8
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices_per_proc}")
    import jax
    import numpy as np

    from ebcc_tpu import EBCCConfig, ResidualMode
    from ebcc_tpu.parallel import mesh as pmesh
    from ebcc_tpu.parallel.batch import ShardedCodec

    assert pmesh.init_distributed(args.coordinator,
                                  num_processes=args.num_processes,
                                  process_id=args.process_id)
    nproc = jax.process_count()
    ndev = len(jax.devices())

    h, w = args.size
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    frames_per_dev = max(1, args.frames // ndev)
    b = frames_per_dev * ndev
    # every process materialises only its addressable shard
    local = np.stack([
        base + rng.normal(0, 0.05, (h, w)).astype(np.float32)
        for _ in range(b)])

    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=args.error,
                     max_batch=b)
    mesh = pmesh.make_mesh(n_data=ndev, n_space=1)
    sc = ShardedCodec(h, w, cfg, mesh=mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P("data", None, None))
    data = jax.make_array_from_callback(
        (b, h, w), sharding, lambda idx: local[idx])
    target = np.full(b, args.error, np.float32)

    res = sc.encode_error_bounded(data, target, 1e-6)  # compile
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    res = sc.encode_error_bounded(data, target, 1e-6)
    jax.block_until_ready(res)
    dt = time.perf_counter() - t0
    if args.process_id == 0:
        print(json.dumps({
            "processes": nproc, "devices": ndev, "frames": b,
            "grid_points_per_s": b * h * w / dt, "seconds": dt,
        }))
    return 0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--local", type=int, default=None,
                   help="spawn N local worker processes")
    p.add_argument("--from-slurm", action="store_true")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--devices-per-proc", type=int, default=2)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, nargs=2, default=[240, 480])
    p.add_argument("--error", type=float, default=0.5)
    args = p.parse_args()

    if args.process_id is not None:
        return worker(args)

    if args.from_slurm:
        args.process_id = int(os.environ["SLURM_PROCID"])
        args.num_processes = int(os.environ["SLURM_NTASKS"])
        # SLURM_JOB_NODELIST is a compressed expression (e.g.
        # "nid[001-002]"); scontrol expands it to real hostnames
        head = subprocess.run(
            ["scontrol", "show", "hostnames",
             os.environ["SLURM_JOB_NODELIST"]],
            capture_output=True, text=True,
            check=True).stdout.splitlines()[0].strip()
        args.coordinator = f"{head}:12321"
        return worker(args)

    if args.local:
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = []
        for i in range(args.local):
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--coordinator", f"localhost:{port}",
                   "--num-processes", str(args.local),
                   "--process-id", str(i),
                   "--devices-per-proc", str(args.devices_per_proc),
                   "--frames", str(args.frames),
                   "--size", str(args.size[0]), str(args.size[1]),
                   "--error", str(args.error)]
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)
            procs.append(subprocess.Popen(cmd, env=env))
        rc = max(p.wait() for p in procs)
        return rc
    p.error("pass --local N, --from-slurm, or explicit worker args")


if __name__ == "__main__":
    sys.exit(main())
