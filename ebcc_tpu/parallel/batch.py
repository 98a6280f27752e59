"""Frame-parallel (data-parallel) compression over a device mesh.

Replaces the reference's ``multiprocessing.Pool`` fan-out over frames /
pressure levels (/root/reference/scripts/run_pointwise.py:76-79) with a
``jit`` over a sharded ``[B, H, W]`` stack: XLA partitions every transform,
plane scan and packing op over the ``data`` axis; per-frame work is
independent so no collectives are inserted except for scalar reductions the
caller requests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.config import EBCCConfig
from ..codec.pipeline import FrameCodec
from .mesh import frame_sharding, make_mesh


class ShardedCodec:
    """FrameCodec whose batched encode/decode runs sharded over a mesh."""

    def __init__(self, h: int, w: int, config: EBCCConfig, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.codec = FrameCodec(h, w, config)
        sh = frame_sharding(self.mesh)
        rep = jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec("data"))
        self._encode_eb = jax.jit(
            self.codec._encode_error_bounded,
            in_shardings=(sh, rep, None))
        # pointwise targets are frame-sharded too; build the jit once (a
        # fresh jax.jit per call would retrace/recompile on the hot path)
        self._encode_eb_pw = jax.jit(
            self.codec._encode_error_bounded, in_shardings=(sh, sh, None))
        self._encode_rate = jax.jit(
            self.codec._encode_rate_targeted,
            in_shardings=(sh, rep, rep))
        self._decode = jax.jit(self.codec._decode_stage)

    def encode_error_bounded(self, data, target, qbase):
        target = jnp.asarray(target)
        if target.ndim == 3:
            return self._encode_eb_pw(data, target, jnp.float32(qbase))
        return self._encode_eb(data, target, jnp.float32(qbase))

    def encode_rate_targeted(self, data, base_budget, resid_budget):
        return self._encode_rate(data, base_budget, resid_budget)

    def decode(self, *args):
        return self._decode(*args)

    @property
    def base(self):
        return self.codec.base

    @property
    def resid(self):
        return self.codec.resid


@functools.lru_cache(maxsize=8)
def sharded_codec(h: int, w: int, config: EBCCConfig, mesh) -> ShardedCodec:
    """One ShardedCodec (and so one set of compiled programs) per
    geometry, config and mesh."""
    return ShardedCodec(h, w, config, mesh)


def compress_sharded(data, config: EBCCConfig | None = None, mesh=None,
                     error_bound=None):
    """Blob-compatible compress() that dispatches one sharded device call
    for the whole [B, H, W] stack (B should be a multiple of the data-axis
    size)."""
    import dataclasses

    from .. import api

    config = config or EBCCConfig()
    data = np.asarray(data, np.float32)
    frames = data.reshape(-1, data.shape[-2], data.shape[-1])
    mesh = mesh if mesh is not None else make_mesh()
    cfg = dataclasses.replace(config, max_batch=frames.shape[0])
    sc = sharded_codec(frames.shape[-2], frames.shape[-1], cfg, mesh)
    return api.compress(frames, cfg, error_bound=error_bound, codec=sc)
