"""Worker process for the two-process jax.distributed test.

Usage: python distributed_worker.py <process_id> <num_processes> <port>

Each process owns 2 virtual CPU devices; together they form a 2x2
(data x space) mesh spanning a process (DCN-analogue) boundary.  The
worker validates the codec's cross-host collective patterns: sharded
per-frame min/max reductions (the stack-wide statistics pattern) and a
psum over both mesh axes inside shard_map (the error-stat reduction
pattern), then prints OK.
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
# must be set before the first jax import
os.environ["JAX_PLATFORMS"] = "cpu"
# 4 virtual devices in 2 processes time-slice one core: raise the
# collective-rendezvous timeouts or the cross-process ppermutes in the
# sharded encode ABORT (same flags as conftest, which this worker skips)
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=2"
    " --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
    " --xla_cpu_collective_call_terminate_timeout_seconds=1200")

import jax  # noqa: E402

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ebcc_tpu.parallel import mesh as pmesh  # noqa: E402

assert pmesh.init_distributed(f"localhost:{port}", num_processes=nproc,
                              process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, len(jax.devices())

mesh = pmesh.make_mesh(n_data=2, n_space=2)

gshape = (4, 16, 32)
base = np.arange(np.prod(gshape), dtype=np.float32).reshape(gshape)
sharding = NamedSharding(mesh, P("data", "space", None))
arr = jax.make_array_from_callback(gshape, sharding, lambda idx: base[idx])

# pattern 1: per-frame reductions over a spatially-sharded stack
# (frame min/max statistics; XLA inserts the cross-process collectives)
@jax.jit
def minmax(x):
    return (jax.lax.with_sharding_constraint(
        jnp.min(x, axis=(-2, -1)), NamedSharding(mesh, P())),
        jax.lax.with_sharding_constraint(
            jnp.max(x, axis=(-2, -1)), NamedSharding(mesh, P())))

mn, mx = minmax(arr)
np.testing.assert_array_equal(np.asarray(mn), base.min(axis=(-2, -1)))
np.testing.assert_array_equal(np.asarray(mx), base.max(axis=(-2, -1)))

# pattern 2: psum across BOTH mesh axes inside shard_map (the sharded
# error-statistic reduction), crossing the process boundary
@jax.jit
def total(x):
    def local(v):
        return jax.lax.psum(jnp.sum(v), ("data", "space"))

    return jax.shard_map(local, mesh=mesh,
                         in_specs=P("data", "space", None),
                         out_specs=P())(x)

t = float(np.asarray(total(arr)))
assert t == float(base.sum()), (t, float(base.sum()))

# pattern 3: the full spatially-sharded error-bounded ENCODE with the
# space axis laid across the process boundary, so the halo-exchange
# ppermutes of the lifting DWT and the frame-stat reductions genuinely
# cross the DCN-analogue link — the closest this 1-host environment gets
# to the >=85% N-host scaling target (BASELINE.json; the throughput
# printed here measures a time-sliced single core, NOT partitioning
# quality — see scripts/scaling_bench.py's caveat).
import time  # noqa: E402

from jax.sharding import Mesh  # noqa: E402

from ebcc_tpu import EBCCConfig, ResidualMode  # noqa: E402
from ebcc_tpu.ops import bitplane as bp  # noqa: E402
from ebcc_tpu.parallel.spatial import SpatialShardedCodec  # noqa: E402

from ebcc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

# global devices arrive grouped by process ([p0d0, p0d1, p1d0, p1d1]);
# transpose so each space PAIR spans the two processes
devs = np.asarray(jax.devices()).reshape(nproc, 2).T
xmesh = Mesh(devs, axis_names=("data", "space"))

h, w = 96, 160
b = devs.shape[0]
yy, xx = np.mgrid[0:h, 0:w]
fbase = (260 + 25 * np.sin(yy / h * np.pi) *
         np.cos(xx / w * 2 * np.pi)).astype(np.float32)
rng = np.random.default_rng(0)
gdata = np.stack([fbase + rng.normal(0, 0.05, fbase.shape).astype(np.float32)
                  for _ in range(b)])

# shallow transforms: row-sharding needs (hp/n) % 2**levels == 0 and
# (hp/n) >> levels >= 4 (spatial.py geometry rule; hp = 96 here)
cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, max_batch=b,
                 base_levels=3, residual_levels=2)
spc = SpatialShardedCodec(h, w, cfg, mesh=xmesh)
codec = spc.codec

sh_in = NamedSharding(xmesh, P("data", None, None))
garr = jax.make_array_from_callback(gdata.shape, sh_in,
                                    lambda idx: gdata[idx])
tnp = np.full((b,), 0.5, np.float32)
gtarget = jax.make_array_from_callback(
    tnp.shape, NamedSharding(xmesh, P("data")), lambda idx: tnp[idx])


@jax.jit
def recon_maxerr(res, data):
    """Closed-form reconstruction at the chosen truncation (== the decoded
    stream by the embedded-coder property) -> replicated global max err."""
    an_b = bp.analyze(res.base_coef.astype(jnp.int32), codec.base.spec)
    use_pure = ~res.skip_residual & ~res.resid_feasible
    bs = jnp.where(use_pure, res.bs_pure, res.bs_q)
    ks = jnp.where(use_pure, res.ks_pure, res.ks_q)
    rec = codec._base_recon(codec._recon_at(an_b, codec.base, bs, ks),
                            res.mn, res.mx, res.dc_b)
    an_r = bp.analyze(res.resid_coef.astype(jnp.int32), codec.resid.spec)
    rec_r = codec._resid_recon(
        codec._recon_at(an_r, codec.resid, res.bs_r, res.ks_r),
        res.rmin, res.rmax, res.dc_r)
    has_r = (~res.skip_residual & res.resid_feasible)[:, None, None]
    rec = rec + jnp.where(has_r, rec_r, 0.0)
    return jax.lax.with_sharding_constraint(
        jnp.max(jnp.abs(rec - data)), NamedSharding(xmesh, P()))


res = spc.encode_error_bounded(garr, gtarget, 1e-6)  # compile + run
jax.block_until_ready(res)
t0 = time.perf_counter()
res = spc.encode_error_bounded(garr, gtarget, 1e-6)
jax.block_until_ready(res)
enc_s = time.perf_counter() - t0
err = float(np.asarray(recon_maxerr(res, garr)))
assert err <= 0.5, f"bound violated in cross-process encode: {err}"
print(f"sharded-encode ok process {pid}/{nproc}: {b}x{h}x{w} on mesh "
      f"{dict(zip(xmesh.axis_names, xmesh.devices.shape))} (space axis "
      f"spans processes), max err {err:.4f}, "
      f"{b * h * w / enc_s:.0f} pts/s (virtual-mesh figure)")

print(f"OK process {pid}/{nproc}: {len(jax.devices())} global devices, "
      f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")
