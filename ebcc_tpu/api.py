"""Array-in / bytes-out compression API.

This is the device-batched replacement for the reference's HDF5-filter entry
points (``encode_climate_variable`` / ``decode_climate_variable``,
/root/reference/src/j2k_codec.h:460, :1095) and for the tempfile+HDF5 detour
of ``EBCCDirectWrapper`` (/root/reference/ebcc_wrapper/direct_wrapper.py:72-
84): frames go straight from device memory to container bytes.

Host responsibilities are intentionally thin: batching, the zstd entropy
stage over the (already rate-truncated) residual bitstream — matching the
reference's ``ZSTD_compress(..., 22)`` stage (j2k_codec.h:656-658) — and
container assembly.  All search/transform work happens in one jitted device
call per batch.
"""

from __future__ import annotations

import functools
import math

import jax
import numpy as np

from .codec import container
from .codec import pipeline as _pipeline
from .codec.config import (EBCCConfig, ResidualMode, base_error_quantile,
                           pure_fallback_disabled)
from .codec.pipeline import FrameCodec
from .ops import bitplane as bp
from .runtime import native as _native
from .utils import logging as elog

# residual streams smaller than this are dropped (j2k_codec.h:653)
MIN_RESID_BYTES = 16

# Early pure-base decision margin (_decide_pure): the pure variant is
# selected WITHOUT packing the residual layer when its extra base bits are
# <= NUM/DEN of the residual stream bits.  zstd on the near-random bitplane
# residual streams measures 1.0-1.3x; 2.5x (= DEN/NUM) is far beyond it, so
# whenever the rule fires the exact post-zstd comparison would have picked
# pure too.  Part of the container selection rule — mirrored bit-for-bit by
# native/ebcc_cpu_encoder.cc (decide_pure) to keep backends byte-identical.
PURE_DECIDE_NUM = 2
PURE_DECIDE_DEN = 5

# Tier-0 of the same rule: when the pure variant's extra base bits cannot
# pay for even the residual part's fixed container overhead (~24 B header
# + minimum zstd frame for a >MIN_RESID_BYTES payload), pure wins no matter
# what the residual stream compresses to.  This tier needs NO residual
# quantities at all, so the native encoder skips building/searching the
# residual layer entirely for such frames.
TIER0_MAX_EXTRA_BITS = 128

# EncodeResult fields whose device->host fetch is deferred until the small
# flags decide which representation (sparse / u8 / u16 / exact f32) is
# needed.  The coefficient forms — including the typical sparse pairs —
# are deferred: the drain reads the per-frame counts from the prefetched
# small fields first, then starts a TRIMMED async fetch covering only the
# populated prefix of the sparse arrays.  Residual forms are fetched only
# when some frame keeps residual bits (see _pack_layer_streams' empty-arena
# early-out).
_F32_COEF_FIELDS = ("base_coef", "resid_coef")
_DEFERRED_FIELDS = _pipeline.DEFERRED_FIELDS


def _unpack_meta(packed, nchunks):
    """Inverse of pipeline._pack_meta: ONE fetched int32 array [B, N] ->
    the dict of small EncodeResult fields (the hostq entries return the
    packed form: one device->host transfer instead of ~40)."""
    packed = np.asarray(packed)
    out = {}
    off = 0
    segs_cols = 2 + 2 * nchunks
    for name in _pipeline.EncodeResult._fields:
        if name in _DEFERRED_FIELDS:
            continue
        k = segs_cols if name.startswith("segs_") else 1
        v = np.ascontiguousarray(packed[:, off:off + k])
        off += k
        if name in _pipeline.META_F32:
            v = v.view(np.float32)
        elif name in _pipeline.META_BOOL:
            v = v != 0
        out[name] = v[:, 0] if k == 1 else v
    if off != packed.shape[1]:
        raise RuntimeError("packed metadata layout mismatch")
    return out


def pointwise_targets(frames: np.ndarray, eb: np.ndarray,
                      ratio: float) -> np.ndarray:
    """Per-point search targets for POINTWISE_MAX_ERROR mode.

    The reference narrows the target to ``eb * ratio * (1 - eps)``
    (j2k_codec.h:842-845) so decode-side arithmetic drift cannot push a
    point past the user bound.  Two corrections to that scheme here:

    * ``1 - 1e-8`` rounds to exactly ``1.0f`` — at float32 the reference's
      margin is a no-op.
    * The actual drift (jitted vs native CPU decoder; last-ulp differences
      in the f32 lifting arithmetic) scales with the frame's u16
      quantisation step ``(mx - mn) / 65535`` — NOT with ``eb`` — so a
      purely relative margin cannot absorb it for small bounds.

    The margin therefore subtracts one u16 quantum per frame (measured
    cross-backend drift: 0.074 quanta worst case over the ERA5 fixtures —
    13x headroom), floored at half the scaled bound so degenerate bounds
    below ~2 quanta still encode (there the cross-backend guarantee
    needs the exact-value patch, models/direct.py).  Both encoder
    backends compute targets through this one function, keeping their
    containers byte-identical (tests/test_cpu_encoder.py).
    """
    rng = (frames.max(axis=(-2, -1)) -
           frames.min(axis=(-2, -1))).astype(np.float32)
    slack = rng * np.float32(1.0 / 65535.0)
    t = eb.astype(np.float32) * np.float32(ratio)
    return np.maximum(t - slack[:, None, None],
                      t * np.float32(0.5)).astype(np.float32)


def _scale_u16_host(frames: np.ndarray):
    """Host-side u16 quantisation for the hostq encode entries.

    The pipeline's first step is u16 scaling either way; doing it on the
    host halves the host->device transfer (uint16 planes instead of f32).
    Returns ``(u, mn, mx, maxq)``; the caller must tighten every error
    target by ``maxq`` (the per-frame quantisation error) because the
    device-side error reference becomes the u16-dequantised field — the
    end-to-end bound on the original data then holds by the triangle
    inequality (pipeline._hostq_prelude).

    Native implementation (SIMD + threads); the native CPU encoder shares
    its exact maxq arithmetic, which keeps the backends byte-identical.
    """
    return _native.scale_u16_batch(frames)


def _zstd_compress(data: bytes, level: int) -> bytes:
    """The container format mandates zstd (docs/FORMAT.md).  The native
    runtime's system libzstd is the one the CPU encoder
    (native/ebcc_cpu_encoder.cc) packs with, so both paths emit
    byte-identical frames."""
    return _native.zstd_compress_batch([data], level)[0]


def _zstd_decompress(data: bytes, max_size: int) -> bytes:
    return _native.zstd_decompress_batch([data], [max_size])[0]


@functools.lru_cache(maxsize=16)
def _codec_for_cached(h: int, w: int, config: EBCCConfig) -> FrameCodec:
    return FrameCodec(h, w, config)


def _codec_for(h: int, w: int, config: EBCCConfig) -> FrameCodec:
    import dataclasses

    # the backend flags are pure routing — they affect nothing inside the
    # jitted pipeline, so normalise them out of the cache key (a routing
    # flag change must not re-trace/compile the whole codec)
    return _codec_for_cached(
        h, w, dataclasses.replace(config, decode_backend="auto",
                                  encode_backend="auto"))


def _use_cpu_encode(config: EBCCConfig) -> bool:
    """Whether config.encode_backend selects the native CPU encoder
    ("auto" and "device" run the jitted device pipeline)."""
    return config.encode_backend == "cpu"


def _mask_tail(stream: bytes, nbits: int) -> bytes:
    """Zero the dangling bits of the final byte past ``nbits``.

    A stream trimmed out of a longer prefix arena would otherwise carry
    whatever bits followed it in the arena — making the emitted bytes
    depend on how much arena happened to be packed (e.g. on whether the
    combined variant was also built) instead of on the selection alone.
    The decoder reads zeros past the end either way; this pins the BYTES.
    Mirrored by the native encoder (ebcc_cpu_encoder.cc pack_variant)."""
    pad = -int(nbits) % 8
    if pad and stream:
        return stream[:-1] + bytes([stream[-1] & (0xFF << pad) & 0xFF])
    return stream


def _batches(n: int, size: int):
    for i in range(0, n, size):
        yield i, min(i + size, n)


def compress(data, config: EBCCConfig | None = None, *,
             error_bound=None, codec=None, qbase=None) -> bytes:
    """Compress ``data`` ([..., H, W] float32) into a container blob.

    ``error_bound``: per-point bound array (same shape as data) for
    POINTWISE_MAX_ERROR mode; ignored otherwise.
    ``codec``: optional pre-built (possibly mesh-sharded) FrameCodec.
    ``qbase``: base-layer feasibility quantile override (defaults to the
    EBCC_INIT_BASE_ERROR_QUANTILE env var).
    """
    import dataclasses

    config = config or EBCCConfig()
    data = np.asarray(data, np.float32)
    if data.ndim < 2:
        raise ValueError("data must be at least 2-D")
    shape = data.shape
    h, w = shape[-2], shape[-1]
    if min(h, w) < 4:
        raise ValueError("frames must be at least 4x4")
    frames = data.reshape(-1, h, w)
    if frames.shape[0] == 0:
        raise ValueError("no frames to compress")
    if not np.isfinite(frames).all():
        raise ValueError("NaN or Inf in data (j2k_codec.h:451-458)")
    # small frames cannot support deep transforms: L levels need
    # 2**(L+1) < min(h, w) (else the deepest lifting has < 4 samples and
    # the mirror pad would exceed the frame).  Clamp — the effective
    # geometry is stored in the container, so decode follows automatically.
    max_lv = max(0, (min(h, w) - 1).bit_length() - 2)
    if config.base_levels > max_lv or config.residual_levels > max_lv:
        if codec is not None:
            raise ValueError(
                f"frames of {h}x{w} support at most {max_lv} DWT levels; "
                "rebuild the provided codec with fewer levels")
        config = dataclasses.replace(
            config, base_levels=min(config.base_levels, max_lv),
            residual_levels=min(config.residual_levels, max_lv))
    n = frames.shape[0]
    mode = config.mode
    if qbase is None:
        qbase = base_error_quantile()
    if codec is not None and config.encode_backend == "cpu":
        raise ValueError("encode_backend='cpu' cannot be combined with a "
                         "pre-built device codec; drop one of the two")
    _native.require()
    if codec is None and _use_cpu_encode(config):
        # byte-identical containers from the native encoder, with no
        # device compile or transfers
        from .runtime import cpu_encoder
        return cpu_encoder.compress(frames, config,
                                    error_bound=error_bound, qbase=qbase,
                                    _validated=True)
    codec = codec or _codec_for(h, w, config)
    pointwise = mode == ResidualMode.POINTWISE_MAX_ERROR
    if pointwise:
        if error_bound is None:
            raise ValueError("POINTWISE_MAX_ERROR requires error_bound")
        eb = np.asarray(error_bound, np.float32).reshape(-1, h, w)
        # per-point target with the drift-absorbing safety margin
        # (reference semantics: j2k_codec.h:842-845)
        eb = pointwise_targets(frames, eb, config.pointwise_max_error_ratio)

    # a call smaller than max_batch compiles/pads at its own size instead
    # of padding up by repetition (single-slice callers like the delta
    # chains would otherwise pay max_batch x the compute)
    bsz = min(config.max_batch, n)
    pending = []  # (n_valid, EncodeResult) — device results in flight

    def _start_transfers(rd, resn):
        """Begin the async d2h of each layer's chosen coefficient form,
        TRIMMED to the populated sparse prefix; the trimmed device views
        are stashed in rd so _fetch_coef reuses the same arrays instead of
        re-slicing.  Idempotent (one shot per batch)."""
        if rd.get("_transfers_started"):
            return
        rd["_transfers_started"] = True

        def _start(layer):
            try:
                if resn[f"{layer}_sparse_ok"].all():
                    d, v = _trim_sparse(rd, layer, resn[f"{layer}_nsig"])
                    rd[f"{layer}_sp_delta"], rd[f"{layer}_sp_val"] = d, v
                    d.copy_to_host_async()
                    v.copy_to_host_async()
                elif resn[f"{layer}_pack8_ok"].all():
                    rd[f"{layer}_pack8"].copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass

        _start("base")
        if not np.all(resn["const"] | resn["skip_residual"] |
                      resn["decided_pure"]):
            # some frame keeps residual bits: its form must be fetched
            _start("resid")

    def _fetch_small(rd):
        """The small-field dict: from the packed-metadata array when the
        hostq entry supplied one (ONE transfer for ~40 fields), else
        per-leaf device_get (the f32 / mesh-wrapped path)."""
        meta = rd.get("_meta")
        if meta is not None:
            resn = _unpack_meta(meta, codec.base.spec.nchunks)
        else:
            resn = jax.device_get({k: v for k, v in rd.items()
                                   if not k.startswith("_") and
                                   k not in _DEFERRED_FIELDS})
        resn["decided_pure"] = _decide_pure(resn, mode)
        return resn

    def prime(entry):
        """Non-blocking cross-batch prefetch: once a pending batch's small
        fields are READY (compute done), kick off its trimmed coefficient
        transfers so they overlap the current batch's host packing.  Never blocks on an unfinished
        batch — that would serialize device compute with host work."""
        _, res, rd = entry
        if rd.get("_transfers_started") or "_resn" in rd:
            return
        meta = rd.get("_meta")
        small = ({"_meta": meta} if meta is not None else
                 {k: v for k, v in rd.items()
                  if not k.startswith("_") and k not in _DEFERRED_FIELDS})
        try:
            if not all(getattr(v, "is_ready", lambda: True)()
                       for v in small.values()):
                return
        except Exception:
            return
        rd["_resn"] = _fetch_small(rd)
        _start_transfers(rd, rd["_resn"])

    def drain(entry):
        nb_valid, res, rd = entry
        # fetch the small fields first (async-prefetched); the coefficient
        # representation (sparse / u8 / u16 / exact f32) is chosen per
        # layer from the flags and only that one is fetched
        resn = rd.pop("_resn", None)
        if resn is None:
            resn = _fetch_small(rd)
        _check_plane_budget(resn, config)
        _start_transfers(rd, resn)
        streams = _pack_streams(resn, codec, rd)
        zblobs = _zstd_stage(resn, streams, nb_valid, config)
        return [_assemble_frame(resn, i, h, w, config, mode,
                                streams, zblobs) for i in range(nb_valid)]

    # drains run serially on the caller's thread; the async
    # copy_to_host_async prefetches overlap device work with host packing
    drained = []  # per-batch frame lists, in order

    # host-quantised dispatch: u16 planes are uploaded instead of f32
    # (half the bytes); targets are tightened by the quantisation error.
    # Mesh-wrapped codecs without the hostq entries keep the f32 path.
    use_hostq = hasattr(codec, "encode_error_bounded_hostq")

    for lo, hi in _batches(n, bsz):
        batch = frames[lo:hi]
        nb = batch.shape[0]
        if nb < bsz:  # pad to the static batch size
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], bsz - nb, axis=0)], axis=0)
        hq = _scale_u16_host(batch) if use_hostq else None
        if mode in (ResidualMode.MAX_ERROR, ResidualMode.RELATIVE_ERROR,
                    ResidualMode.POINTWISE_MAX_ERROR):
            if pointwise:
                ebb = eb[lo:hi]
                if ebb.shape[0] < bsz:
                    ebb = np.concatenate(
                        [ebb, np.repeat(ebb[-1:], bsz - ebb.shape[0], 0)], 0)
                target = ebb
            elif mode == ResidualMode.RELATIVE_ERROR:
                if hq is not None:
                    rng = hq[2] - hq[1]
                else:
                    rng = batch.max(axis=(-2, -1)) - batch.min(axis=(-2, -1))
                target = (config.error * rng).astype(np.float32)
            else:
                target = np.full(bsz, config.error, np.float32)
            if hq is not None:
                u, mnb, mxb, maxq = hq
                target = target - (maxq if target.ndim == 1
                                   else maxq[:, None, None])
                res, meta = codec.encode_error_bounded_hostq(
                    u, mnb, mxb, target, qbase)
            else:
                res = codec.encode_error_bounded(batch, target, qbase)
                meta = None
        elif mode in (ResidualMode.NONE, ResidualMode.SPARSIFICATION_FACTOR):
            base_budget = np.full(bsz, int(32 * h * w / config.base_cr),
                                  np.int32)
            if mode == ResidualMode.SPARSIFICATION_FACTOR:
                resid_budget = np.full(bsz, int(8 * h * w /
                                                config.residual_cr), np.int32)
            else:
                resid_budget = np.zeros(bsz, np.int32)
            if hq is not None:
                u, mnb, mxb, _ = hq
                res, meta = codec.encode_rate_targeted_hostq(
                    u, mnb, mxb, base_budget, resid_budget)
            else:
                res = codec.encode_rate_targeted(batch, base_budget,
                                                 resid_budget)
                meta = None
        else:
            raise ValueError(f"unsupported mode {mode}")
        # start device->host copies of the small fields now; the (large)
        # coefficient representation is fetched at drain time once the
        # flags pick the smallest valid form
        rd = res._asdict()
        if meta is not None:
            rd["_meta"] = meta  # ONE packed array instead of ~40 leaves
            try:
                meta.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
        else:
            for name, leaf in rd.items():
                if name in _DEFERRED_FIELDS:
                    continue
                try:
                    leaf.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    break
        pending.append((hi - lo, res, rd))
        if len(pending) > config.prefetch_batches:
            entry = pending.pop(0)
            for e in pending:
                prime(e)
            drained.append(drain(entry))
    while pending:
        entry = pending.pop(0)
        for e in pending:
            prime(e)
        drained.append(drain(entry))
    out_frames = [f for frames_ in drained for f in frames_]
    return container.pack_blob(out_frames)


# fields of EncodeResult that differ per quantile candidate in
# encode_error_bounded_multi (everything else is shared device buffers)
_PER_Q_FIELDS = ("base_bits_q", "bs_q", "ks_q", "bs_r", "ks_r",
                 "km_q", "km_r", "mbits_q", "mbits_r", "segs_q", "segs_r",
                 "rmin", "rmax", "dc_r", "max_step_r",
                 "resid_coef", "resid_bits", "resid_feasible",
                 "skip_residual", "resid_pack16", "resid_pack8",
                 "resid_shift", "resid_shift8", "resid_pack16_ok",
                 "resid_pack8_ok", "resid_sp_delta", "resid_sp_val",
                 "resid_nsig", "resid_sparse_ok")


def compress_multi_q(data, qs, config: EBCCConfig | None = None, *,
                     error_bound=None) -> list[bytes]:
    """Compress under K base-quantile candidates in one device dispatch
    per batch; returns one blob per candidate.

    The base layer (transform, analysis, truncation scans, packed arena)
    is computed and transferred ONCE and shared across candidates — only
    each candidate's truncation points and residual layer differ.  This is
    the rate optimiser's engine (models/rate_opt.py), replacing K full
    re-compressions (the reference's golden-section probes,
    image_compression.py:499-567).
    """
    import dataclasses

    config = config or EBCCConfig()
    if config.mode not in (ResidualMode.MAX_ERROR,
                           ResidualMode.RELATIVE_ERROR,
                           ResidualMode.POINTWISE_MAX_ERROR):
        raise ValueError("compress_multi_q needs an error-bounded mode")
    qs = [float(q) for q in qs]
    data = np.asarray(data, np.float32)
    if data.ndim < 2:
        raise ValueError("data must be at least 2-D")
    h, w = data.shape[-2], data.shape[-1]
    if min(h, w) < 4:
        raise ValueError("frames must be at least 4x4")
    frames = data.reshape(-1, h, w)
    if not np.isfinite(frames).all():
        raise ValueError("NaN or Inf in data (j2k_codec.h:451-458)")
    max_lv = max(0, (min(h, w) - 1).bit_length() - 2)
    if config.base_levels > max_lv or config.residual_levels > max_lv:
        config = dataclasses.replace(
            config, base_levels=min(config.base_levels, max_lv),
            residual_levels=min(config.residual_levels, max_lv))
    n = frames.shape[0]
    _native.require()
    if _use_cpu_encode(config):
        # same routing rule as compress(): K per-candidate CPU encodes.
        # Byte-identical to the device multi-q path — multi-q equals per-q
        # compression (tests/test_models.py::test_multi_q_identical_to_per_q)
        # and the CPU encoder equals api.compress per q.
        from .runtime import cpu_encoder
        return [cpu_encoder.compress(frames, config,
                                     error_bound=error_bound, qbase=q,
                                     _validated=True)
                for q in qs]
    codec = _codec_for(h, w, config)
    mode = config.mode
    pointwise = mode == ResidualMode.POINTWISE_MAX_ERROR
    if pointwise:
        if error_bound is None:
            raise ValueError("POINTWISE_MAX_ERROR requires error_bound")
        eb_all = np.asarray(error_bound, np.float32).reshape(-1, h, w)
        eb_all = pointwise_targets(frames, eb_all,
                                   config.pointwise_max_error_ratio)

    out_frames = [[] for _ in qs]
    bsz = min(config.max_batch, n)
    use_hostq = hasattr(codec, "encode_error_bounded_multi_hostq")
    for lo, hi in _batches(n, bsz):
        batch = frames[lo:hi]
        nb = batch.shape[0]
        if nb < bsz:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], bsz - nb, axis=0)], axis=0)
        hq = _scale_u16_host(batch) if use_hostq else None
        if pointwise:
            ebb = eb_all[lo:hi]
            if ebb.shape[0] < bsz:
                ebb = np.concatenate(
                    [ebb, np.repeat(ebb[-1:], bsz - ebb.shape[0], 0)], 0)
            target = ebb
        elif mode == ResidualMode.RELATIVE_ERROR:
            if hq is not None:
                rng = hq[2] - hq[1]
            else:
                rng = batch.max(axis=(-2, -1)) - batch.min(axis=(-2, -1))
            target = (config.error * rng).astype(np.float32)
        else:
            target = np.full(bsz, config.error, np.float32)
        if hq is not None:
            u, mnb, mxb, maxq = hq
            target = target - (maxq if target.ndim == 1
                               else maxq[:, None, None])
            res_list, metas = codec.encode_error_bounded_multi_hostq(
                u, mnb, mxb, target, qs)
        else:
            res_list = codec.encode_error_bounded_multi(batch, target, qs)
            metas = None
        rd0 = res_list[0]._asdict()
        if metas is not None:
            for m in metas:  # start the d2h copies while compute drains
                try:
                    m.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    break
            # K packed-metadata transfers (one per candidate, each also
            # carrying the shared base-layer fields) instead of
            # ~40 + 29K individual leaf fetches
            dicts = [_unpack_meta(m, codec.base.spec.nchunks)
                     for m in metas]
            shared = {k: v for k, v in dicts[0].items()
                      if k not in _PER_Q_FIELDS}
            perq_all = [{f: d[f] for f in _PER_Q_FIELDS
                         if f not in _DEFERRED_FIELDS} for d in dicts]
        else:
            # ONE host sync fetches the shared base-layer fields and every
            # candidate's small per-q fields together
            shared, perq_all = jax.device_get((
                {k: v for k, v in rd0.items()
                 if k not in _DEFERRED_FIELDS and k not in _PER_Q_FIELDS},
                [{f: r._asdict()[f] for f in _PER_Q_FIELDS
                  if f not in _DEFERRED_FIELDS} for r in res_list]))
        resn_all = []
        for pq in perq_all:
            resn = dict(shared, **pq)
            resn["decided_pure"] = _decide_pure(resn, mode)
            _check_plane_budget(resn, config)
            resn_all.append(resn)
        # one base arena serves every candidate's truncation (embedded
        # streams: all candidate rates are prefixes; masked selections
        # splice out of the same arena, needing their plane's end).
        # Decided-pure (candidate, frame) pairs emit only the pure variant,
        # so their q-selection need not be covered.
        arena_pure = _arena_bits(shared, "pure", shared["base_bits_pure"])
        trunc_b = np.maximum.reduce(
            [np.where(resn["decided_pure"], 0,
                      _arena_bits(resn, "q", resn["base_bits_q"]))
             for resn in resn_all])
        trunc_b = np.maximum(trunc_b, arena_pure)
        base_stream = _pack_layer_streams(shared, codec, rd0, "base",
                                          trunc_b)
        for k, res in enumerate(res_list):
            rd = res._asdict()
            resn = resn_all[k]
            trunc_r = np.where(resn["skip_residual"] | resn["decided_pure"],
                               0,
                               _arena_bits(resn, "r", resn["resid_bits"]))
            resid_stream = _pack_layer_streams(resn, codec, rd, "resid",
                                               trunc_r)
            streams = (base_stream, resid_stream)
            zblobs = _zstd_stage(resn, streams, hi - lo, config)
            for i in range(hi - lo):
                out_frames[k].append(_assemble_frame(
                    resn, i, h, w, config, mode, streams, zblobs))
    return [container.pack_blob(f) for f in out_frames]


def _decide_pure(res, mode) -> np.ndarray:
    """Frames whose pure-base variant is selected WITHOUT building the
    base+residual candidate (bool [B]).

    Two tiers, evaluated from the small fields alone (before any residual
    coefficient fetch / arena pack / zstd):

    * pure is *required*: the residual stream would be dropped (fewer than
      MIN_RESID_BYTES) or is infeasible — _assemble_frame's pure_required
      arm would win unconditionally.
    * pure *certainly wins the size comparison*: feasible, and its extra
      base bits cost at most PURE_DECIDE_NUM/DEN of the residual stream's
      raw bits (see the constants above for why that margin is safe).

    This is part of the container selection rule (not a transport detail):
    native/ebcc_cpu_encoder.cc mirrors it exactly so both encoders keep
    emitting byte-identical containers.  Undecided frames fall through to
    the exact post-zstd byte comparison in _assemble_frame, so the rule
    can only skip work, never change feasibility; the error bound is
    independent of the variant choice.
    """
    const = np.asarray(res["const"], bool)
    if mode not in (ResidualMode.MAX_ERROR, ResidualMode.RELATIVE_ERROR,
                    ResidualMode.POINTWISE_MAX_ERROR):
        res["decided_pure_pre"] = np.zeros(const.shape, bool)
        return np.zeros(const.shape, bool)
    skip = np.asarray(res["skip_residual"], bool)
    br = np.asarray(res["mbits_r"], np.int64)
    bq = np.asarray(res["mbits_q"], np.int64)
    bpp = np.asarray(res["mbits_pure"], np.int64)
    present = ~skip & (br > 0) & ((br + 7) // 8 > MIN_RESID_BYTES)
    required = ~skip & (~present | ~np.asarray(res["resid_feasible"], bool))
    decided = required
    tier0 = np.zeros(const.shape, bool)
    if not pure_fallback_disabled():
        feas_p = np.asarray(res["base_feasible_pure"], bool)
        # tier-0 decides pre-residual (native skips the layer's searches);
        # recorded separately so the plane-budget check mirrors which
        # frames the native encoder actually builds a residual layer for
        tier0 = (~const & ~skip & feas_p &
                 (bpp - bq <= TIER0_MAX_EXTRA_BITS))
        wins = ((bpp - bq) * PURE_DECIDE_DEN <= br * PURE_DECIDE_NUM)
        tier2 = (present & np.asarray(res["resid_feasible"], bool) &
                 feas_p & wins & ~tier0 & ~required)
        decided = decided | tier0 | tier2
        if tier0.any() or tier2.any():
            # the margin tiers are empirical (zstd < 2.5x on residual
            # streams); count firings so a CR regression on new workloads
            # is traceable to this heuristic rather than the codec
            elog.debug("decide_pure: tier0=%d tier2=%d required=%d of %d",
                       int(tier0.sum()), int(tier2.sum()),
                       int(required.sum()), const.size)
    res["decided_pure_pre"] = tier0
    return decided & ~const


def _zstd_stage(res, streams, n, config):
    """Entropy-pack residual streams, batched over native threads."""
    _, resid_stream = streams
    decided = res.get("decided_pure")
    rbytes = []
    idx = []
    for i in range(n):
        if (res["const"][i] or res["skip_residual"][i] or
                (decided is not None and decided[i])):
            continue
        rb = resid_stream(i, int(res["mbits_r"][i]),
                          int(res["km_r"][i]), res["segs_r"][i])
        if len(rb) > MIN_RESID_BYTES:
            rbytes.append(rb)
            idx.append(i)
    if not rbytes:
        return {}
    packed = _native.zstd_compress_batch(rbytes, config.zstd_level)
    return dict(zip(idx, packed))


def _sparse_bucket(kmax: int, kcap: int) -> int:
    """Fetch length for sparse arrays: kmax rounded up to a multiple of
    8192 (bounded distinct slice programs for the compile cache; typical
    caps are ~141K entries, so at most ~17 programs per geometry)."""
    if kmax <= 4096:
        return min(kcap, 4096)
    return min(kcap, -(-int(kmax) // 8192) * 8192)


def _trim_sparse(rd, layer, counts):
    """Device-side views of one layer's sparse pair, trimmed to the bucket
    covering max(nsig) — only the populated prefix is fetched."""
    deltas, vals = rd[f"{layer}_sp_delta"], rd[f"{layer}_sp_val"]
    k = _sparse_bucket(int(np.max(np.asarray(counts), initial=0)),
                       deltas.shape[1])
    if k >= deltas.shape[1]:
        return deltas, vals
    return deltas[:, :k], vals[:, :k]


def _fetch_coef(res, rd, layer):
    """Pull the smallest valid coefficient form for one layer off device.

    Returns ("sparse", deltas, vals, counts, shifts) or
    ("dense", coef ndarray, shifts-or-None) ready for the native coder,
    smallest representation first: sparse -> u8 -> u16 -> exact f32.
    """
    if res[f"{layer}_sparse_ok"].all():
        deltas, vals = _trim_sparse(rd, layer, res[f"{layer}_nsig"])
        return ("sparse", np.asarray(deltas), np.asarray(vals),
                res[f"{layer}_nsig"], res[f"{layer}_shift"])
    if res[f"{layer}_pack8_ok"].all():
        return ("dense", np.asarray(rd[f"{layer}_pack8"]),
                res[f"{layer}_shift8"])
    if res[f"{layer}_pack16_ok"].all():
        return ("dense", np.asarray(rd[f"{layer}_pack16"]),
                res[f"{layer}_shift"])
    return ("dense", np.asarray(rd[f"{layer}_coef"]), None)


def _pack_layer_streams(res, codec, rd, layer, trunc):
    """Entropy-pack one layer's (coefficients, truncation) pairs.

    Native host coder (native/ebcc_coder.cc).  Returns a per-frame callable
    stream(i, bits, km=-1, segs=None) yielding trimmed byte streams — any
    prefix of the embedded stream is valid, so one arena serves every
    truncation up to ``trunc[i]``.  ``km >= 0`` (format v4): the final
    plane is chunk-masked; the stream is spliced out of the prefix arena
    using the ``segs`` bit counts (bp.splice_masked_stream defines the
    layout; trunc[i] must cover that plane's end).  ``rd`` holds the
    not-yet-fetched device arrays (coefficient forms).
    """
    geom = codec.base if layer == "base" else codec.resid
    spec = geom.spec
    if int(trunc.max(initial=0)) == 0:
        # no frame keeps any bits of this layer (typical for the residual
        # when pure base wins everywhere): skip the coefficient fetch
        return lambda i, bits, km=-1, segs=None: b""
    form = _fetch_coef(res, rd, layer)
    if form[0] == "sparse":
        _, deltas, vals, counts, shifts = form
        arena = _native.coder_encode_batch_sparse(
            deltas, vals, counts, shifts, spec.height, spec.width,
            trunc, spec.group_levels, spec.nplanes, spec.nchunks)
    else:
        _, coef, shifts = form
        arena = _native.coder_encode_batch(
            coef, trunc, spec.group_levels, spec.nplanes, spec.nchunks,
            shifts=shifts)

    def raw(i, bits):
        return _mask_tail(arena[i, : (int(bits) + 7) // 8].tobytes(), bits)

    def stream(i, bits, km=-1, segs=None):
        if km < 0:
            return raw(i, bits)
        sb, nbits = bp.splice_masked_stream(raw(i, int(np.sum(segs))),
                                            segs, km, spec.nchunks)
        assert nbits == int(bits), "masked stream length mismatch"
        return sb

    return stream


def _arena_bits(res, sel, bits):
    """Arena coverage one selection needs: its prefix bits, or — when its
    final plane is chunk-masked — that plane's end (the splice pulls kept
    refine chunks from the plane tail)."""
    km = np.asarray(res[f"km_{sel}"])
    segs = np.asarray(res[f"segs_{sel}"], np.int64)
    return np.where(km >= 0, segs.sum(-1), np.asarray(bits, np.int64))


def _pack_streams(res, codec, rd):
    """Both layers' stream packers: (base(...), resid(...))."""
    decided = res.get("decided_pure")
    if decided is None:
        decided = np.zeros(np.asarray(res["const"]).shape, bool)
    arena_pure = _arena_bits(res, "pure", res["base_bits_pure"])
    # decided frames emit only the pure variant: the arena need not cover
    # the q-selection, and their residual layer is never fetched
    trunc_b = np.where(decided, arena_pure,
                       np.maximum(_arena_bits(res, "q", res["base_bits_q"]),
                                  arena_pure))
    trunc_r = np.where(res["skip_residual"] | decided, 0,
                       _arena_bits(res, "r", res["resid_bits"]))
    return (_pack_layer_streams(res, codec, rd, "base", trunc_b),
            _pack_layer_streams(res, codec, rd, "resid", trunc_r))


def _geom(config):
    return (config.base_levels, config.residual_levels, config.nchunks,
            config.base_nplanes, config.residual_nplanes)


def _check_plane_budget(res, config) -> None:
    """Coefficients above the top scanned plane cannot be represented in
    the stream, while the closed-form search believed they were — a
    silent bound violation (and the packer may write out of bounds).  The
    default plane counts cover any u16 input by construction; user-
    lowered counts must fail loudly BEFORE packing (the native encoder
    returns -3 for the same condition)."""
    if int(np.max(res["max_step_b"])) >= config.base_nplanes:
        raise ValueError(
            "coefficient magnitudes exceed the configured bitplane budget; "
            "raise base_nplanes")
    # the residual budget only matters for frames that may emit residual
    # bits — NONE-mode, skip-residual, and tier-0-decided frames never
    # pack the layer, so an overflowing max_step_r there is harmless (the
    # native encoder does not even build the layer then)
    emits = ~(np.asarray(res["const"]) | np.asarray(res["skip_residual"]) |
              np.asarray(res.get("decided_pure_pre", False)))
    if np.any(emits &
              (np.asarray(res["max_step_r"]) >= config.residual_nplanes)):
        raise ValueError(
            "coefficient magnitudes exceed the configured bitplane budget; "
            "raise residual_nplanes")


def _assemble_frame(res, i, h, w, config, mode, streams, zblobs) -> bytes:
    mn, mx = float(res["mn"][i]), float(res["mx"][i])
    if res["const"][i]:
        return container.pack_frame(int(mode), h, w, mn, mx, const=True,
                                    tot_size=h * w, geom=_geom(config))
    base_stream, _ = streams
    bits_q = int(res["mbits_q"][i])
    bits_pure = int(res["mbits_pure"][i])
    km_q, km_pure = int(res["km_q"][i]), int(res["km_pure"][i])
    mask_q = ((int(res["bs_q"][i]), km_q) if km_q >= 0
              else (container.MASK_NONE, 0))
    mask_pure = ((int(res["bs_pure"][i]), km_pure) if km_pure >= 0
                 else (container.MASK_NONE, 0))
    base_meta = dict(dc_b=float(res["dc_b"][i]),
                     max_step_b=int(res["max_step_b"][i]))
    decided = res.get("decided_pure")
    skip = bool(res["skip_residual"][i])
    resid_feasible = bool(res["resid_feasible"][i])
    error_bounded = mode in (ResidualMode.MAX_ERROR,
                             ResidualMode.RELATIVE_ERROR,
                             ResidualMode.POINTWISE_MAX_ERROR)

    def pack_variant(bits, rpart, km, segs, bmask):
        raw = base_stream(i, bits, km, segs)
        # final entropy stage on the base stream (the reference's base
        # layer is arithmetic-coded inside JPEG2000; ours is raw bitplane
        # output, worth a few percent to zstd)
        z = _zstd_compress(raw, min(config.zstd_level, 10))
        stream, base_z = (z, True) if len(z) < len(raw) else (raw, False)
        return container.pack_frame(
            int(mode), h, w, mn, mx,
            base_stream=stream, base_nbits=bits, base_z=base_z,
            geom=_geom(config), resid=rpart, base_mask=bmask,
            pointwise=mode == ResidualMode.POINTWISE_MAX_ERROR, **base_meta)

    if decided is not None and decided[i]:
        # _decide_pure already ruled for the pure variant (and the residual
        # layer was never packed); same bytes the exact comparison emits
        return pack_variant(bits_pure, None, km_pure, res["segs_pure"][i],
                            mask_pure)

    resid_part = None
    if not skip:
        rbits = int(res["mbits_r"][i])
        km_r = int(res["km_r"][i])
        rmask = ((int(res["bs_r"][i]), km_r) if km_r >= 0
                 else (container.MASK_NONE, 0))
        zblob = zblobs.get(i)
        if zblob is not None:
            resid_part = (float(res["rmin"][i]), float(res["rmax"][i]),
                          float(res["dc_r"][i]), int(res["max_step_r"][i]),
                          rbits, zblob, *rmask)
        else:
            elog.debug("frame %d: residual dropped (<= %d bytes)",
                       i, MIN_RESID_BYTES)

    combined = pack_variant(bits_q, resid_part, km_q, res["segs_q"][i],
                            mask_q)
    if not error_bounded:
        return combined
    # pure-base fallback comparison (j2k_codec.h:663-695)
    pure_required = (not skip) and (resid_part is None or not resid_feasible)
    if pure_fallback_disabled() and not pure_required:
        return combined
    pure = pack_variant(bits_pure, None, km_pure, res["segs_pure"][i],
                        mask_pure)
    # prefer pure only when it actually meets the bound (or is the last
    # resort because the residual path failed) — a smaller-but-infeasible
    # pure stream must not win
    feasible_pure = bool(res["base_feasible_pure"][i])
    if pure_required or (feasible_pure and len(pure) < len(combined)):
        elog.info("frame %d: pure base layer chosen (%d < %d bytes)",
                  i, len(pure), len(combined))
        return pure
    return combined


def _use_cpu_decode(config: EBCCConfig) -> bool:
    """Whether config.decode_backend selects the native CPU decoder
    ("auto" and "device" run the jitted recon)."""
    return config.decode_backend == "cpu"


def _check_uniform_geometry(metas) -> None:
    """Every non-const frame of a blob must share (h, w) and coder
    geometry — the format contract api.decompress enforces on every
    backend (the low-level runtime.cpu_decoder stays permissive)."""
    keys = [(h.h, h.w, h.base_levels, h.resid_levels, h.nchunks,
             h.base_nplanes, h.resid_nplanes) for h in metas
            if not h.flags & container.FLAG_CONST]
    if keys and any(k != keys[0] for k in keys[1:]):
        raise ValueError("mixed coder geometries in one blob")


def decompress(blob: bytes, config: EBCCConfig | None = None) -> np.ndarray:
    """Decompress a container blob back to [N, H, W] float32."""
    config = config or EBCCConfig()
    _native.require()
    if _use_cpu_decode(config):
        from .runtime import cpu_decoder
        _check_uniform_geometry(
            [container.unpack_frame(f)[0]
             for f in container.unpack_blob(blob)])
        return cpu_decoder.decompress(blob)
    frames = container.unpack_blob(blob)
    metas = [container.unpack_frame(f) for f in frames]
    n = len(metas)
    out = [None] * n
    todo = []
    for idx, (hdr, zblob, base_stream, tot) in enumerate(metas):
        if hdr.flags & container.FLAG_CONST:
            out[idx] = np.full((hdr.h, hdr.w), hdr.mn, np.float32)
        else:
            todo.append(idx)
    if not todo:
        return np.stack(out) if n > 1 else np.asarray(out[0])[None]

    h, w = metas[todo[0]][0].h, metas[todo[0]][0].w
    # frames are self-describing: adopt the encoder's coder geometry
    # (bitstream layout depends on it) rather than this config's defaults
    g0 = metas[todo[0]][0]
    import dataclasses
    config = dataclasses.replace(
        config, base_levels=g0.base_levels, residual_levels=g0.resid_levels,
        nchunks=g0.nchunks, base_nplanes=g0.base_nplanes,
        residual_nplanes=g0.resid_nplanes)
    _check_uniform_geometry([m[0] for m in metas])
    codec = _codec_for(h, w, config)
    bsz = min(config.max_batch, len(todo))
    pending = []  # (idxs, device_result)

    def drain(entry):
        idxs_, dev = entry
        dec = np.asarray(dev)
        for k, idx in enumerate(idxs_):
            out[idx] = dec[k]

    for lo, hi in _batches(len(todo), bsz):
        idxs = todo[lo:hi]
        base_streams = [b""] * bsz
        resid_streams = [b""] * bsz
        bb = np.zeros(bsz, np.int32)
        msb_ = np.zeros(bsz, np.int32)
        mn = np.zeros(bsz, np.float32)
        mx = np.zeros(bsz, np.float32)
        dcb = np.zeros(bsz, np.float32)
        hasr = np.zeros(bsz, bool)
        rb = np.zeros(bsz, np.int32)
        msr = np.zeros(bsz, np.int32)
        rmn = np.zeros(bsz, np.float32)
        rmx = np.zeros(bsz, np.float32)
        dcr = np.zeros(bsz, np.float32)
        mask_b = np.full(bsz, -1, np.int32)
        keep_b = np.zeros(bsz, np.int32)
        mask_r = np.full(bsz, -1, np.int32)
        keep_r = np.zeros(bsz, np.int32)
        zlist, zmax, zpos = [], [], []
        for k, idx in enumerate(idxs):
            hdr, zblob, base_stream, _ = metas[idx]
            if hdr.base_mask_plane != container.MASK_NONE:
                if hdr.base_mask_plane >= hdr.base_nplanes:
                    raise ValueError("corrupt EBCC-TPU frame header")
                mask_b[k] = hdr.base_mask_plane
                keep_b[k] = hdr.base_keep_mask
            if hdr.resid_mask_plane != container.MASK_NONE:
                if hdr.resid_mask_plane >= hdr.resid_nplanes:
                    raise ValueError("corrupt EBCC-TPU frame header")
                mask_r[k] = hdr.resid_mask_plane
                keep_r[k] = hdr.resid_keep_mask
            if hdr.flags & container.FLAG_BASE_Z:
                base_stream = _zstd_decompress(
                    base_stream, (hdr.base_nbits + 7) // 8)
            # header-declared bits must be backed by bytes; a truncated
            # frame must not silently decode to a plausible approximation
            # (matches runtime/cpu_decoder.py)
            if len(base_stream) * 8 < hdr.base_nbits:
                raise ValueError("truncated EBCC-TPU frame stream")
            base_streams[k] = base_stream
            bb[k] = hdr.base_nbits
            msb_[k] = hdr.max_step_b
            mn[k], mx[k], dcb[k] = hdr.mn, hdr.mx, hdr.dc_b
            if hdr.flags & container.FLAG_RESID:
                zlist.append(zblob)
                zmax.append((hdr.resid_nbits + 7) // 8)
                zpos.append(k)
                rb[k] = hdr.resid_nbits
                msr[k] = hdr.max_step_r
                rmn[k], rmx[k], dcr[k] = hdr.rmin, hdr.rmax, hdr.dc_r
                hasr[k] = True
        if zlist:
            unpacked = _native.zstd_decompress_batch(zlist, zmax)
            for k, rbytes in zip(zpos, unpacked):
                if len(rbytes) * 8 < int(rb[k]):
                    raise ValueError("truncated EBCC-TPU frame stream")
                resid_streams[k] = rbytes
        bspec, rspec = codec.base.spec, codec.resid.spec
        v16_b, bend_b, ok_b = _native.coder_decode_batch_u16(
            base_streams, bb, msb_, bspec.height, bspec.width,
            bspec.group_levels, bspec.nplanes, bspec.nchunks,
            mask_plane=mask_b, keep_mask=keep_b)
        v16_r, bend_r, ok_r = _native.coder_decode_batch_u16(
            resid_streams, rb, msr, rspec.height, rspec.width,
            rspec.group_levels, rspec.nplanes, rspec.nchunks,
            mask_plane=mask_r, keep_mask=keep_r)
        if ok_b.all() and ok_r.all():
            dev = codec.recon_packed(v16_b, bend_b, mn, mx, dcb, hasr,
                                     v16_r, bend_r, rmn, rmx, dcr)
        else:  # >14 decoded planes somewhere: full-precision path
            coef_b = _native.coder_decode_batch(
                base_streams, bb, msb_, bspec.height, bspec.width,
                bspec.group_levels, bspec.nplanes, bspec.nchunks,
                mask_plane=mask_b, keep_mask=keep_b)
            coef_r = _native.coder_decode_batch(
                resid_streams, rb, msr, rspec.height, rspec.width,
                rspec.group_levels, rspec.nplanes, rspec.nchunks,
                mask_plane=mask_r, keep_mask=keep_r)
            dev = codec.recon(coef_b, mn, mx, dcb, hasr,
                              coef_r, rmn, rmx, dcr)
        try:
            dev.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        pending.append((idxs, dev))
        if len(pending) > config.prefetch_batches:
            drain(pending.pop(0))
    while pending:
        drain(pending.pop(0))
    return np.stack(out)
