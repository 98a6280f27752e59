"""Device mesh construction for multi-device / multi-host runs.

The reference's only parallelism is process pools + SLURM array jobs over
independent frames (/root/reference/scripts/run_pointwise.py:76-79,
ebcc_wrapper/delta_compression.py:223-245).  The equivalent here is a
``jax.sharding.Mesh`` with a ``data`` axis (frames / pressure levels / time
steps — the reference's process-pool axis) and an optional ``space`` axis
(intra-frame spatial tiling with halo exchange, a new capability with no
reference counterpart).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int | None = None, n_space: int = 1,
              devices=None) -> Mesh:
    """Build a (data, space) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_space
    devs = np.asarray(devices[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(devs, axis_names=("data", "space"))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a [B, H, W] stack of frames over the data axis."""
    return NamedSharding(mesh, P("data", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-host initialisation (jax.distributed).

    The reference scales multi-node only as independent SLURM jobs
    (scripts/launch_hdf5_compression_sweep.sbatch); here N hosts join one
    JAX runtime and meshes span their devices (DCN between hosts, ICI
    within).  Explicit arguments win; otherwise the standard coordinator
    env vars are honoured.  Returns True when distributed mode was
    initialised, False for a standalone run (no-op).  Initialisation
    errors propagate — a half-joined cluster must fail loudly, not fall
    back to silent single-host behaviour.
    Exercised by tests/test_distributed.py on two local processes.
    """
    import os
    if coordinator_address is None:
        coordinator_address = (os.environ.get("JAX_COORDINATOR_ADDRESS") or
                               os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True
