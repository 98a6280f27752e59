"""Per-stage profiling of the compress/decompress pipeline on a GPU
(fails without one).  Prints the device, then a JSON dict of stage ->
seconds for one batch.

Includes an ON-DEVICE stage breakdown of the encode program
(transform/counts -> truncation bisections -> chunk-mask greedy scans ->
residual layer), measured as cumulative-prefix jitted programs whose
deltas attribute device time per stage (XLA may fuse differently per
prefix; treat deltas as estimates).  Device work is timed up to
``jax.block_until_ready``.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_stage_breakdown(codec, u, mnb, mxb, target, qbase, reps=3):
    """Stage -> best seconds, via cumulative-prefix programs."""
    import jax
    import jax.numpy as jnp

    from ebcc_tpu.codec.pipeline import _Eval
    from ebcc_tpu.ops import bitplane as bp

    c = codec
    qb = jnp.float32(qbase)

    def p1(u, mn, mx, target):  # transform + analysis + counts
        dataq, const, dc, ci = c._hostq_prelude(u, mn, mx)
        an = bp.analyze(ci, c.base.spec)
        counts = bp.segment_counts(an, c.base.spec)
        cand = bp.candidate_bits(counts, c.base.spec)
        return (jnp.sum(cand) + jnp.sum(dataq) +
                jnp.sum(an.mag) + jnp.sum(dc))

    def _searches(u, mn, mx, target):
        dataq, const, dc, ci = c._hostq_prelude(u, mn, mx)
        an = bp.analyze(ci, c.base.spec)
        counts = bp.segment_counts(an, c.base.spec)
        cand = bp.candidate_bits(counts, c.base.spec)

        def recon_b(rc):
            return c._base_recon(rc, mn, mx, dc)

        ev = _Eval(an, c.base, recon_b, dataq, target)
        q = c._search_truncation(an, c.base, recon_b, dataq, target, qb,
                                 cand=cand, ev=ev)
        pure = c._search_truncation(an, c.base, recon_b, dataq, target,
                                    jnp.float32(0.0), cand=cand, ev=ev)
        return dataq, dc, an, counts, recon_b, ev, q, pure

    def p2(u, mn, mx, target):  # + q and pure truncation bisections
        _, dc, an, counts, _, _, q, pure = _searches(u, mn, mx, target)
        return (q[0].sum() + pure[0].sum() + q[3].sum() + pure[3].sum() +
                q[4].sum() + pure[4].sum())

    def p3(u, mn, mx, target):  # + both chunk-mask greedy scans
        dataq, dc, an, counts, recon_b, ev, q, pure = _searches(
            u, mn, mx, target)
        bits_q, feas_q, maxd_q, bs_q, ks_q = q
        bits_p, feas_p, _, bs_p, ks_p = pure
        mq = c._search_mask(an, c.base, recon_b, dataq, target, qb, bs_q,
                            bits_q, feas_q, counts, ev=ev)
        mp = c._search_mask(an, c.base, recon_b, dataq, target,
                            jnp.float32(0.0), bs_p, bits_p, feas_p, counts,
                            ev=ev)
        return (mq[2].sum() + mp[2].sum() + mq[1].sum() + mp[1].sum() +
                mq[5].sum() + mp[5].sum())

    def p4(u, mn, mx, target):  # full encode (residual layer + packings)
        res, meta = c._encode_error_bounded_hostq(u, mn, mx, target, qb)
        return jnp.sum(meta)

    out = {}
    prev = None
    names = ["transform_counts", "truncation_bisections",
             "mask_greedy_scans", "residual_and_packings"]
    for name, fn in zip(names, [p1, p2, p3, p4]):
        jf = jax.jit(fn)
        jax.block_until_ready(jf(u, mnb, mxb, target))  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(jf(u, mnb, mxb, target))
            best = min(best, time.perf_counter() - t0)
        out[f"cum_{name}"] = best
        out[f"stage_{name}"] = best - (prev or 0.0)
        prev = best
    return out


def main():
    import jax

    from ebcc_tpu import EBCCConfig, ResidualMode, api
    from ebcc_tpu.codec.pipeline import FrameCodec
    from ebcc_tpu.dataprep import synthetic_frames
    from ebcc_tpu.runtime import native
    from ebcc_tpu.utils import device
    from ebcc_tpu.utils.compile_cache import enable_compile_cache

    info = device.require_gpu()
    print(f"device: {device.nvidia_smi_line()}; {info}", file=sys.stderr)
    enable_compile_cache()

    B, H, W = 8, 721, 1440
    data = synthetic_frames(B, H, W, sigma=0.05, seed=0)

    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                     max_batch=B)
    codec = FrameCodec(H, W, cfg)
    target = np.full(B, 0.5, np.float32)

    t = {}

    # warmup (hostq path: what api.compress dispatches)
    u, mnb, mxb, maxq = api._scale_u16_host(data)
    res, meta = codec.encode_error_bounded_hostq(u, mnb, mxb, target - maxq,
                                                 1e-6)
    jax.block_until_ready((res, meta))

    t0 = time.perf_counter()
    u, mnb, mxb, maxq = api._scale_u16_host(data)
    t["0_host_scale_u16"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res, meta = codec.encode_error_bounded_hostq(u, mnb, mxb, target - maxq,
                                                 1e-6)
    jax.block_until_ready((res, meta))
    t["1_device_encode_search"] = time.perf_counter() - t0

    # on-device stage breakdown of stage 1 (cumulative-prefix programs)
    tgt_dev = None
    try:
        import jax.numpy as jnp
        tgt_dev = jnp.asarray(target - maxq)
        t.update(device_stage_breakdown(codec, jnp.asarray(u),
                                        jnp.asarray(mnb), jnp.asarray(mxb),
                                        tgt_dev, 1e-6))
    except Exception as e:  # breakdown is diagnostic: never kill the run
        t["device_stage_breakdown_error"] = str(e)[:200]

    t0 = time.perf_counter()
    # mirror api.compress: large coefficient forms fetched lazily, and the
    # early pure decision gates the residual fetch/pack/zstd entirely
    rd = res._asdict()
    resn = api._unpack_meta(meta, codec.base.spec.nchunks)
    resn["decided_pure"] = api._decide_pure(resn, cfg.mode)
    t["2_device_to_host_transfer_small"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    streams = api._pack_streams(resn, codec, rd)
    t["3_coef_fetch_plus_native_pack"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    zblobs = api._zstd_stage(resn, streams, B, cfg)
    t["4_zstd"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    frames = [api._assemble_frame(resn, i, H, W, cfg, cfg.mode, streams,
                                  zblobs) for i in range(B)]
    t["5_assemble"] = time.perf_counter() - t0

    # ---- decode stages ----
    from ebcc_tpu.codec import container
    full = container.pack_blob(frames)
    metas = [container.unpack_frame(f) for f in container.unpack_blob(full)]

    bspec, rspec = codec.base.spec, codec.resid.spec
    base_streams = [
        native.zstd_decompress_batch([m[2]],
                                     [(m[0].base_nbits + 7) // 8])[0]
        if m[0].flags & container.FLAG_BASE_Z else m[2] for m in metas]
    bb = np.array([m[0].base_nbits for m in metas], np.int64)
    ms = np.array([m[0].max_step_b for m in metas], np.int32)

    zlist = [m[1] for m in metas if m[0].flags & container.FLAG_RESID]
    zmax = [(m[0].resid_nbits + 7) // 8 for m in metas
            if m[0].flags & container.FLAG_RESID]
    t0 = time.perf_counter()
    if zlist:
        unpacked = native.zstd_decompress_batch(zlist, zmax)
    t["6_unzstd"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mb = np.array([-1 if m[0].base_mask_plane == container.MASK_NONE
                   else m[0].base_mask_plane for m in metas], np.int32)
    kb = np.array([m[0].base_keep_mask for m in metas], np.uint32)
    coef_b = native.coder_decode_batch(base_streams, bb, ms, bspec.height,
                                       bspec.width, bspec.group_levels,
                                       bspec.nplanes, bspec.nchunks,
                                       mask_plane=mb, keep_mask=kb)
    t["7_native_base_decode"] = time.perf_counter() - t0

    rs = [b""] * B
    rbn = np.zeros(B, np.int64)
    msr = np.zeros(B, np.int32)
    k = 0
    for i, m in enumerate(metas):
        if m[0].flags & container.FLAG_RESID:
            rs[i] = unpacked[k]
            rbn[i] = m[0].resid_nbits
            msr[i] = m[0].max_step_r
            k += 1
    t0 = time.perf_counter()
    mr = np.array([-1 if m[0].resid_mask_plane == container.MASK_NONE
                   else m[0].resid_mask_plane for m in metas], np.int32)
    kr = np.array([m[0].resid_keep_mask for m in metas], np.uint32)
    coef_r = native.coder_decode_batch(rs, rbn, msr, rspec.height,
                                       rspec.width, rspec.group_levels,
                                       rspec.nplanes, rspec.nchunks,
                                       mask_plane=mr, keep_mask=kr)
    t["8_native_resid_decode"] = time.perf_counter() - t0

    mn = np.array([m[0].mn for m in metas], np.float32)
    mx = np.array([m[0].mx for m in metas], np.float32)
    dcb = np.array([m[0].dc_b for m in metas], np.float32)
    hasr = np.array([bool(m[0].flags & container.FLAG_RESID)
                     for m in metas])
    rmn = np.array([m[0].rmin for m in metas], np.float32)
    rmx = np.array([m[0].rmax for m in metas], np.float32)
    dcr = np.array([m[0].dc_r for m in metas], np.float32)

    out = codec.recon(coef_b, mn, mx, dcb, hasr, coef_r, rmn, rmx, dcr)
    jax.block_until_ready(out)  # warmup
    t0 = time.perf_counter()
    out = codec.recon(coef_b, mn, mx, dcb, hasr, coef_r, rmn, rmx, dcr)
    jax.block_until_ready(out)
    t["9_device_recon"] = time.perf_counter() - t0

    err = float(np.max(np.abs(np.asarray(out) - data)))
    t["max_err"] = err
    t["total_enc"] = sum(v for k, v in t.items() if k[0] in "12345")
    t["total_dec"] = sum(v for k, v in t.items() if k[0] in "6789")
    print(json.dumps({k: round(v, 4) for k, v in t.items()}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
