"""Jitted encode/decode stages of the two-layer error-bounded codec.

Batched redesign of ``encode_climate_variable`` /
``decode_climate_variable`` (/root/reference/src/j2k_codec.h:460-744, 1095-
1149).  The structure of the reference pipeline is preserved — u16 scaling,
lossy base layer, residual layer with truncation search, error-bound
enforcement with a feasibility quantile, pure-base fallback — but every
stage is batched over frames and every search loop is collapsed:

* The reference's base-CR bisection re-encodes the frame with OpenJPEG 6-9
  times per frame (j2k_codec.h:345-396).  Here the base layer is an
  *embedded* bitstream, so all candidate rates are prefixes of one stream
  and their reconstructions are closed-form quantisations evaluated in one
  batched pass (a ``lax.scan`` over bitplanes + one fine pass).
* The reference's residual truncation bisection runs ~15 sequential SPIHT
  decodes (j2k_codec.h:608-649).  Same collapse applies.

The host never sees intermediate reconstructions; one jitted call per batch
returns packed bitstreams, chosen truncation points and header metadata.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import bitplane as bp
from ..ops import dwt, frame, weights
from .config import EBCCConfig, ResidualMode

U16_MAX = 65535.0
RESID_SCALE = 255.0  # reference residual quantisation scale (spiht_re.h:12)

# jax.named_scope names of the encode's three largest device stages: the
# truncation bisections, the chunk-mask greedy scans, and the residual
# layer plus the transfer packings.  Device-trace reductions
# (chip_smoke.py) attribute kernel time to the innermost of these.
SCOPE_TRUNC = "ebcc_trunc_search"
SCOPE_MASK = "ebcc_mask_search"
SCOPE_RESID = "ebcc_resid_pack"
SCOPES = (SCOPE_TRUNC, SCOPE_MASK, SCOPE_RESID)


def _scoped(name):
    """Trace a method under ``jax.named_scope(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


class _Eval:
    """Candidate-evaluation unit shared by the truncation and chunk-mask
    searches: reconstruct the coefficients at a (plane, chunks) or
    (plane, drop-mask) candidate, inverse transform, reduce to
    (max excess, violation fraction) per frame.  ``target`` is [B]
    (scalar bound per frame) or [B, H, W] (per-point bound)."""

    def __init__(self, an, geom, recon_fn, data_ref, target):
        self.an, self.geom = an, geom
        self.recon_fn, self.data_ref = recon_fn, data_ref
        self.tgt3 = target if target.ndim == 3 else target[:, None, None]

    def _stats(self, rec):
        err = jnp.abs(self.data_ref - self.recon_fn(rec)) - self.tgt3
        return (jnp.max(err, axis=(-2, -1)),
                jnp.mean(err > 0, axis=(-2, -1)))

    def trunc(self, b, js=None, jr=None):
        """Stats at a prefix candidate (None js/jr = plane complete)."""
        rec = bp.recon_truncated(self.an, b, sig_chunks=js,
                                 refine_chunks=jr, spec=self.geom.spec)
        return self._stats(rec)

    def masked(self, b, drop):
        """Stats at a chunk-mask candidate (``drop`` [B, J] bool)."""
        return self._stats(bp.recon_masked(self.an, b, drop, self.geom.spec))


class LayerGeom(NamedTuple):
    levels: int
    hp: int
    wp: int
    spec: bp.CoderSpec
    cap_words: int


def _make_geom(h, w, levels, nplanes, nchunks, cap_bits_per_px):
    hp = frame.padded_size(h, levels)
    wp = frame.padded_size(w, levels)
    g = levels + 1  # quadtree depth; padded dims divide 2**(levels+1)
    spec = bp.CoderSpec(height=hp, width=wp, group_levels=g,
                        nplanes=nplanes, nchunks=nchunks)
    cap_words = (h * w * cap_bits_per_px + 31) // 32
    return LayerGeom(levels, hp, wp, spec, cap_words)


class EncodeResult(NamedTuple):
    """Device outputs of one batched encode call (all leading dim B).

    The bitstreams themselves are NOT packed on device: the transform +
    truncation search runs on the device, and the chosen (coefficients,
    truncation) pairs are turned into bytes by the native host coder
    (native/ebcc_coder.cc) — mirroring the split in the reference, whose
    entropy stage is also host-native.
    """

    mn: jax.Array
    mx: jax.Array
    const: jax.Array            # bool: constant field
    dc_b: jax.Array
    max_step_b: jax.Array
    base_coef: jax.Array        # f32 [B, hp, wp] weighted base coefficients
    base_bits_q: jax.Array      # truncation meeting the feasibility quantile
    base_bits_pure: jax.Array   # truncation meeting the bound everywhere
    base_feasible_pure: jax.Array  # bool: pure base meets bound everywhere
    # chosen truncation points as (plane, fine-chunk) pairs [B] — the
    # closed-form reconstruction at these points equals the decoded
    # stream's (embedded-coder property), letting consumers reproduce the
    # decoder's view without packing bits
    bs_q: jax.Array
    ks_q: jax.Array
    bs_pure: jax.Array
    ks_pure: jax.Array
    bs_r: jax.Array
    ks_r: jax.Array
    # format-v4 chunk masks of each selection's final plane: km_* is the
    # keep bitmask (-1 = pure prefix, no mask), mbits_* the FINAL stream
    # length (masked length, or the prefix length when unmasked; the bits
    # fields above always report the prefix candidate), segs_* the
    # [2 + 2J] per-segment bit counts of plane bs_* the host needs to
    # splice the masked stream out of the prefix arena (bp.mask_segments)
    km_q: jax.Array
    km_pure: jax.Array
    km_r: jax.Array
    mbits_q: jax.Array
    mbits_pure: jax.Array
    mbits_r: jax.Array
    segs_q: jax.Array
    segs_pure: jax.Array
    segs_r: jax.Array
    rmin: jax.Array
    rmax: jax.Array
    dc_r: jax.Array
    max_step_r: jax.Array
    resid_coef: jax.Array       # f32 [B, hp_r, wp_r] residual coefficients
    resid_bits: jax.Array
    resid_feasible: jax.Array   # bool: base@q + residual meets the bound
    skip_residual: jax.Array    # bool: base@q alone already meets the bound
    # compact transfer representations: sign in the top bit, (mag >> shift)
    # below.  pack16 is valid when <= 15 bitplanes are coded, pack8 when
    # <= 7 (typical for the residual layer).  The host fetches the smallest
    # valid form; float32 coefficients remain as the exact fallback.
    base_pack16: jax.Array      # u16 [B, hp, wp]
    resid_pack16: jax.Array     # u16 [B, hp_r, wp_r]
    base_pack8: jax.Array       # u8 [B, hp, wp]
    resid_pack8: jax.Array      # u8 [B, hp_r, wp_r]
    base_shift: jax.Array       # i32 [B]
    resid_shift: jax.Array      # i32 [B]  (shift for the 16-bit form)
    base_shift8: jax.Array      # i32 [B]
    resid_shift8: jax.Array     # i32 [B]
    base_pack16_ok: jax.Array   # bool [B]
    resid_pack16_ok: jax.Array  # bool [B]
    base_pack8_ok: jax.Array    # bool [B]
    resid_pack8_ok: jax.Array   # bool [B]
    # sparse form of the base layer (typically ~6% of coefficients survive
    # the coded-plane threshold): u16 position deltas + u16 packed values,
    # capped at K = hp*wp/8 entries.  Valid (base_sparse_ok) when the count
    # fits the cap, every gap fits u16, and pack16 is exact.
    base_sp_delta: jax.Array    # u16 [B, K]
    base_sp_val: jax.Array      # u16 [B, K]
    base_nsig: jax.Array        # i32 [B]
    base_sparse_ok: jax.Array   # bool [B]
    # sparse form of the residual layer (same layout, cap K_r): after the
    # coded-plane zeroing most residual coefficients are exact zeros, so
    # the sparse transfer typically replaces the 1 B/px dense u8 plane
    resid_sp_delta: jax.Array   # u16 [B, K_r]
    resid_sp_val: jax.Array     # u16 [B, K_r]
    resid_nsig: jax.Array       # i32 [B]
    resid_sparse_ok: jax.Array  # bool [B]


# EncodeResult fields whose device->host fetch api.compress defers until
# the small flags pick the cheapest coefficient representation (sparse /
# u8 / u16 / exact f32); everything else is "small" metadata.
DEFERRED_FIELDS = (
    "base_coef", "resid_coef",
    "base_pack16", "resid_pack16", "base_pack8", "resid_pack8",
    "base_sp_delta", "base_sp_val", "resid_sp_delta", "resid_sp_val")

# dtype map of the small fields for the packed-metadata transfer
# (_pack_meta / api._unpack_meta); i32 otherwise
META_F32 = ("mn", "mx", "dc_b", "rmin", "rmax", "dc_r")
META_BOOL = ("const", "base_feasible_pure", "resid_feasible",
             "skip_residual", "base_pack16_ok", "resid_pack16_ok",
             "base_pack8_ok", "resid_pack8_ok", "base_sparse_ok",
             "resid_sparse_ok")


class FrameCodec:
    """Codec specialised to one frame geometry (H, W) and config."""

    def __init__(self, h: int, w: int, config: EBCCConfig):
        self.h, self.w, self.config = h, w, config
        c = config
        self.base = _make_geom(h, w, c.base_levels, c.base_nplanes,
                               c.nchunks, c.base_cap_bits_per_px)
        self.resid = _make_geom(h, w, c.residual_levels, c.residual_nplanes,
                                c.nchunks, c.residual_cap_bits_per_px)
        self.base_sparse_k = (self.base.hp * self.base.wp) // 8
        self.resid_sparse_k = (self.resid.hp * self.resid.wp) // 8
        self.wb = jnp.asarray(
            weights.weight_array(self.base.hp, self.base.wp, c.base_levels))
        self.wr = jnp.asarray(weights.weight_array(
            self.resid.hp, self.resid.wp, c.residual_levels))
        self._encode_eb = jax.jit(self._encode_error_bounded)
        self._encode_eb_multi = jax.jit(self._encode_error_bounded_multi)
        self._encode_rate = jax.jit(self._encode_rate_targeted)
        self._encode_eb_hostq = jax.jit(self._encode_error_bounded_hostq)
        self._encode_eb_multi_hostq = jax.jit(
            self._encode_error_bounded_multi_hostq)
        self._encode_rate_hostq = jax.jit(self._encode_rate_targeted_hostq)
        self._decode = jax.jit(self._decode_stage)
        self._recon = jax.jit(self._recon_stage)
        self._recon_packed = jax.jit(self._recon_packed_stage)

    # ---------------- shared transform helpers ----------------
    # _dwt/_idwt are override points: the spatially-sharded codec
    # (parallel/spatial.py) swaps in the halo-exchange transform.

    def _dwt(self, x, geom: LayerGeom):
        return dwt.dwt2d_multi(x, geom.levels)

    def _idwt(self, x, geom: LayerGeom):
        return dwt.idwt2d_multi(x, geom.levels)

    def _base_transform_scaled(self, uf):
        """Pad/DC/DWT/quantise a pre-scaled u16 plane (float32 holding
        integers in [0, 65535])."""
        up = frame.pad_symmetric(uf, self.base.levels)
        upc, dc = frame.sub_dc_floor(up)
        coef = self._dwt(upc, self.base)
        ci = jnp.trunc(coef * self.wb).astype(jnp.int32)
        return dc, ci

    def _base_transform(self, data):
        mn, mx = frame.minmax(data)
        const = mn == mx
        u = frame.scale_to_u16(data, mn, mx)
        dc, ci = self._base_transform_scaled(u)
        return mn, mx, const, dc, ci

    def _pack_meta(self, res: EncodeResult):
        """All small (non-deferred) EncodeResult fields bit-packed into ONE
        int32 array [B, N].

        The hostq entries return this alongside the result so api.compress
        pulls the ~40 per-frame scalars in a single device->host transfer
        instead of one per field (api._unpack_meta is the inverse;
        META_F32/META_BOOL define the reinterpretation).
        """
        cols = []
        for name in EncodeResult._fields:
            if name in DEFERRED_FIELDS:
                continue
            v = getattr(res, name)
            v = v.reshape(v.shape[0], -1)
            if v.dtype == jnp.bool_:
                v = v.astype(jnp.int32)
            elif v.dtype == jnp.float32:
                v = jax.lax.bitcast_convert_type(v, jnp.int32)
            else:
                v = v.astype(jnp.int32)
            cols.append(v)
        return jnp.concatenate(cols, axis=1)

    def _hostq_prelude(self, u, mn, mx):
        """Shared front of the hostq entries: u16 plane -> (error
        reference, const flag, dc, quantised coefficients).

        The error reference is the u16-DEQUANTISED field (what the decoder
        can reproduce at best), not the original data — the host quantised
        before upload (api._scale_u16_host) and tightened the error
        targets by the per-frame quantisation error, so the end-to-end
        bound on the ORIGINAL data still holds by the triangle
        inequality."""
        uf = u.astype(jnp.float32)
        dataq = frame.unscale_from_u16(uf, mn, mx)
        const = mn == mx
        dc, ci = self._base_transform_scaled(uf)
        return dataq, const, dc, ci

    def _base_recon(self, rec_coef, mn, mx, dc):
        c = rec_coef / self.wb
        rec = self._idwt(c, self.base) + dc[:, None, None]
        rec = jnp.clip(rec, 0.0, U16_MAX)
        rec = frame.crop(rec, self.h, self.w)
        return frame.unscale_from_u16(rec, mn, mx)

    def _resid_transform(self, resid):
        rmin, rmax = frame.minmax(resid)
        rng = jnp.where(rmax > rmin, rmax - rmin, 1.0)
        rn = (resid - rmin[:, None, None]) / rng[:, None, None] * RESID_SCALE
        rp = frame.pad_symmetric(rn, self.resid.levels)
        rpc, dcr = frame.sub_dc_floor(rp)
        ci = jnp.trunc(
            self._dwt(rpc, self.resid) * self.wr
        ).astype(jnp.int32)
        return rmin, rmax, dcr, ci

    def _resid_recon(self, rec_coef, rmin, rmax, dcr):
        c = rec_coef / self.wr
        rec = self._idwt(c, self.resid) + dcr[:, None, None]
        rec = jnp.clip(rec, 0.0, RESID_SCALE)
        rec = frame.crop(rec, self.h, self.w)
        rng = (rmax - rmin)[:, None, None]
        return rec / RESID_SCALE * rng + rmin[:, None, None]


    # ---------------- truncation search ----------------
    #
    # Feasibility (max-error or violation-quantile) is monotone in coded
    # depth: every further plane / chunk tightens the reconstruction.  The
    # first-feasible searches therefore run as BISECTIONS over the
    # candidate axes — ceil(log2(P)) + ceil(log2(2J)) reconstruction
    # evaluations per selection instead of P + 2J — the same collapse the
    # embedded stream already applied to the reference's re-encode probes.
    # The native CPU encoder mirrors the exact bisection rule
    # (lo=0, hi=n-1, mid=(lo+hi)//2, fixed bit_length(n-1) iterations) so
    # both sides select identical truncations even where monotonicity is
    # imperfect.

    @staticmethod
    def _bisect(n, feasible_at):
        """Per-frame first index in [0, n) where ``feasible_at`` holds
        (assuming monotone feasibility); n-1 if none.  ``feasible_at(idx)``
        maps an int32 [B] index vector to a bool [B] vector."""

        def body(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            f = feasible_at(mid)
            return jnp.where(f, lo, mid + 1), jnp.where(f, mid, hi)

        lo = jnp.zeros((), jnp.int32)
        hi = jnp.full((), n - 1, jnp.int32)
        lo, hi = body(0, (lo, hi))  # shapes promote to [B] after first eval
        for i in range(1, max(1, int.bit_length(n - 1))):
            lo, hi = body(i, (lo, hi))
        # all-infeasible frames overshoot lo past n-1 (converged-at-hi
        # re-evaluations keep failing); clamp to the last index
        return jnp.minimum(lo, n - 1)

    @_scoped(SCOPE_TRUNC)
    def _search_truncation(self, an, geom, recon_fn, data_ref, target,
                           qallow, cand=None, ev=None):
        """Smallest truncation whose violation fraction <= qallow.

        Returns (bits [B], feasible [B], maxdiff at choice [B], bstar,
        kstar).  ``cand`` optionally carries the precomputed candidate-bits
        table so several selections share it; ``ev`` the shared candidate
        evaluator (:class:`_Eval`), built here when absent.
        """
        if cand is None:
            counts = bp.segment_counts(an, geom.spec)
            cand = bp.candidate_bits(counts, geom.spec)  # [B, P, 2J]
        if ev is None:
            ev = _Eval(an, geom, recon_fn, data_ref, target)
        p = geom.spec.nplanes
        j = geom.spec.nchunks

        def ok_of(maxd, viol):
            return jnp.where(qallow > 0, viol <= qallow, maxd <= 0)

        # coarse: first feasible plane-complete candidate (scan order:
        # index q is plane p-1-q)
        pstar = self._bisect(p, lambda idx: ok_of(*ev.trunc(p - 1 - idx)))
        bstar = p - 1 - pstar
        maxd_p, viol_p = ev.trunc(bstar)
        any_ok = ok_of(maxd_p, viol_p)

        # fine: first feasible chunk candidate inside plane bstar
        def fine(idx):
            js = jnp.where(idx < j, idx + 1, j)
            jr = jnp.where(idx < j, 0, idx - j + 1)
            return ev.trunc(bstar, js=js, jr=jr)

        kstar = self._bisect(2 * j, lambda idx: ok_of(*fine(idx)))
        maxd_f, viol_f = fine(kstar)

        bits_pk = jnp.take_along_axis(cand, pstar[:, None, None],
                                      axis=1)[:, 0]  # [B, 2J]
        bits = jnp.take_along_axis(bits_pk, kstar[:, None], axis=1)[:, 0]
        total = cand[:, -1, -1]
        bits = jnp.where(any_ok, bits, total)
        # infeasible frames report the plane-0-complete maxdiff (the best
        # the layer can do); bstar is 0 there so maxd_p is exactly that
        maxd = jnp.where(any_ok, maxd_f, maxd_p)
        return bits, any_ok, maxd, bstar, kstar

    # ---------------- chunk-mask search (format v4) ----------------
    #
    # The fine-truncation PREFIX keeps low-value chunks of the final plane
    # because they come first in scan order; the bit cost of that plane is
    # strongly non-uniform across chunks (scripts/stripe_adaptive_study.py:
    # 6-9% of the base stream is prefix-kept but not needed by the bound).
    # After the prefix search picks plane bs, a greedy per-chunk pass tries
    # to DROP each final-plane chunk outright — a drop is kept only if the
    # reconstruction with all so-far-accepted drops still meets the
    # feasibility rule, so the final mask is feasible by construction.
    # The native CPU encoder mirrors the exact greedy order and accept
    # rule (ebcc_cpu_encoder.cc) so containers stay byte-identical.

    def _mask_enabled(self, geom) -> bool:
        return (self.config.use_chunk_mask and
                geom.spec.nchunks <= 16)  # keep mask is u16 in the header

    @_scoped(SCOPE_MASK)
    def _search_mask(self, an, geom, recon_fn, data_ref, target, qallow,
                     bstar, prefix_bits, feasible, counts, ev=None):
        """Greedy chunk mask of plane ``bstar``.  Returns (use [B] bool,
        km [B] i32 keep bitmask or -1, mbits [B] final bits, maxd_m [B]
        masked max-excess, drop [B, J] bool, segs [B, 2+2J])."""
        spec = geom.spec
        j = spec.nchunks
        nb = an.mag.shape[0]
        segs = bp.mask_segments(counts, bstar, spec)
        if not self._mask_enabled(geom):
            off = jnp.zeros(nb, bool)
            return (off, jnp.full(nb, -1, jnp.int32),
                    jnp.asarray(prefix_bits, jnp.int32),
                    jnp.zeros(nb, jnp.float32), jnp.zeros((nb, j), bool),
                    segs)
        if ev is None:
            ev = _Eval(an, geom, recon_fn, data_ref, target)

        def stats_of(drop):
            return ev.masked(bstar, drop)

        def ok_of(maxd, viol):
            return jnp.where(qallow > 0, viol <= qallow, maxd <= 0)

        if self.config.mask_search == "union":
            # all J single-drop candidates in ONE batched pass (serial
            # depth 2 instead of J): feasible union, else best feasible
            # single by final-plane bit saving (ties -> lowest chunk)
            eye = jnp.eye(j, dtype=bool)
            maxd_s, viol_s = jax.vmap(
                lambda m: ev.masked(bstar, jnp.broadcast_to(m, (nb, j))),
                out_axes=(1, 1))(eye)              # [B, J]
            ok_s = ok_of(maxd_s, viol_s) & feasible[:, None]
            maxd_u, viol_u = stats_of(ok_s)
            ok_u = ok_of(maxd_u, viol_u) & feasible
            save = segs[:, 2:2 + j] + segs[:, 2 + j:]
            bestj = jnp.argmax(jnp.where(ok_s, save, -1), axis=-1)
            single = jnp.zeros((nb, j), bool).at[
                jnp.arange(nb), bestj].set(jnp.any(ok_s, axis=-1))
            drop = jnp.where(ok_u[:, None], ok_s, single)
            # final-choice max excess without another serial eval: the
            # union's, or the chosen single's (bit-identical to an eval
            # of that drop set); unused when no chunk dropped
            maxd_m = jnp.where(
                ok_u, maxd_u,
                jnp.take_along_axis(maxd_s, bestj[:, None], 1)[:, 0])
        else:
            def body(drop, jj):
                cand = drop.at[:, jj].set(True)
                ok = ok_of(*stats_of(cand)) & feasible
                return jnp.where(ok[:, None], cand, drop), None

            drop, _ = jax.lax.scan(body, jnp.zeros((nb, j), bool),
                                   jnp.arange(j))
            maxd_m, _ = stats_of(drop)
        keep = ~drop
        kept_bits = jnp.sum(
            jnp.where(keep, segs[:, 2:2 + j] + segs[:, 2 + j:], 0), axis=-1)
        mbits = segs[:, 0] + segs[:, 1] + kept_bits
        km = jnp.sum(keep.astype(jnp.int32)
                     << jnp.arange(j, dtype=jnp.int32)[None, :], axis=-1)
        prefix_bits = jnp.asarray(prefix_bits, jnp.int32)
        use = feasible & jnp.any(drop, axis=-1) & (mbits < prefix_bits)
        return (use, jnp.where(use, km, -1),
                jnp.where(use, mbits, prefix_bits), maxd_m, drop, segs)

    @staticmethod
    def _pack_small(ci, max_step, b_low):
        """Compact u16/u8 transfer forms of integer coefficients.

        The k-bit form stores sign in the top bit and (mag >> shift) below,
        with shift = max(0, max_step - (k-2)); exact iff shift <= b_low (no
        coded plane below the shift): <= 15 coded planes for u16, <= 7 for
        u8.  Coefficients entirely below the lowest coded plane
        (mag < 2**b_low) are zeroed: every emitted bit at planes >= b_low is
        unchanged (their subtree maxima stay < b_low), the stream is
        truncated above plane b_low - 1, and the zeros make the host
        coder's row-skipping effective.
        Returns (p16, p8, shift16, shift8, ok16, ok8).
        """
        mag_full = jnp.abs(ci).astype(jnp.int32)
        coded = (mag_full >> b_low[:, None, None]) > 0
        neg = ci < 0

        def pack(kbits, sign_bit, dtype):
            shift = jnp.maximum(max_step - (kbits - 2), 0).astype(jnp.int32)
            ok = shift <= b_low
            mag = jnp.where(coded, mag_full >> shift[:, None, None], 0)
            packed = jnp.where(neg & coded, sign_bit + mag,
                               jnp.where(coded, mag, 0)).astype(dtype)
            return packed, shift, ok

        p16, s16, ok16 = pack(16, 32768, jnp.uint16)
        p8, s8, ok8 = pack(8, 128, jnp.uint8)
        return p16, p8, s16, s8, ok16, ok8

    def _sparsify(self, p16, pack16_ok, k=None):
        """Sparse (delta, value) transfer form of a packed-u16 plane.

        One stable sort moves the nonzero positions to the front, with the
        values riding along as a co-sorted operand (no gather).  Whether
        a prefix-sum compaction is faster on the current device has not
        been measured.  Exact semantics pinned by
        tests/test_sparse_transfer.py::
        test_sparsify_matches_sort_formulation.
        """
        b = p16.shape[0]
        n = p16.shape[1] * p16.shape[2]
        k = self.base_sparse_k if k is None else k
        flat = p16.reshape(b, n)
        nzm = flat != 0
        nsig = jnp.sum(nzm, axis=-1, dtype=jnp.int32)
        idx = jnp.arange(n, dtype=jnp.int32)
        keys = jnp.where(nzm, idx, jnp.int32(n))
        pos, vals = jax.lax.sort((keys, flat), num_keys=1)
        pos, vals = pos[:, :k], vals[:, :k]
        delta = jnp.concatenate([pos[:, :1], pos[:, 1:] - pos[:, :-1]],
                                axis=1)
        valid = jnp.arange(k)[None, :] < nsig[:, None]
        gaps_ok = jnp.all(jnp.where(valid, delta, 0) <= 65535, axis=-1)
        ok = (nsig <= k) & gaps_ok & pack16_ok
        return (jnp.where(valid, delta, 0).astype(jnp.uint16),
                jnp.where(valid, vals, 0).astype(jnp.uint16), nsig, ok)

    def _recon_at(self, an, geom, bstar, kstar):
        """Reconstruction at the chosen (plane, chunk) truncation."""
        j = geom.spec.nchunks
        js = jnp.where(kstar < j, kstar + 1, j)
        jr = jnp.where(kstar < j, 0, kstar - j + 1)
        return bp.recon_truncated(an, bstar, sig_chunks=js, refine_chunks=jr,
                                  spec=geom.spec)

    # ---------------- encode stages ----------------

    def _encode_error_bounded(self, data, target, qbase):
        """MAX_ERROR / RELATIVE_ERROR / POINTWISE encode.

        ``target``: [B] absolute error targets, or [B,H,W] pointwise targets.
        ``qbase``: allowed violating fraction for the base layer
        (EBCC_INIT_BASE_ERROR_QUANTILE; j2k_codec.h:469).
        Implements the search + fallback logic of j2k_codec.h:562-695.
        """
        mn, mx, const, dc, ci = self._base_transform(data)
        return self._eb_core(data, mn, mx, const, dc, ci, target, qbase)

    def _encode_error_bounded_hostq(self, u, mn, mx, target, qbase):
        """Error-bounded encode from host-quantised input.

        ``u``: uint16 [B, H, W] (api._scale_u16_host output), ``mn``/``mx``
        the host-computed per-frame ranges.  Halves api.compress's
        host->device transfer relative to :meth:`_encode_error_bounded`
        (the pipeline's first step is u16 quantisation either way).
        ``target`` must already be tightened by the per-frame quantisation
        error — see :meth:`_hostq_prelude`.
        """
        dataq, const, dc, ci = self._hostq_prelude(u, mn, mx)
        res = self._eb_core(dataq, mn, mx, const, dc, ci, target, qbase)
        return res, self._pack_meta(res)

    def _eb_core(self, data_ref, mn, mx, const, dc, ci, target, qbase):
        an_b = bp.analyze(ci, self.base.spec)

        def recon_b(rc):
            return self._base_recon(rc, mn, mx, dc)

        counts_b = bp.segment_counts(an_b, self.base.spec)
        cand_b = bp.candidate_bits(counts_b, self.base.spec)
        ev_b = _Eval(an_b, self.base, recon_b, data_ref, target)
        bits_q, feas_q, maxd_q, bs_q, ks_q = self._search_truncation(
            an_b, self.base, recon_b, data_ref, target, qbase, cand=cand_b,
            ev=ev_b)
        # pure fallback: same embedded stream, quantile target 1.0
        # (j2k_codec.h:668-695) — just another prefix of the same arena.
        bits_pure, feas_pure, _, bs_pure, ks_pure = self._search_truncation(
            an_b, self.base, recon_b, data_ref, target, jnp.float32(0.0),
            cand=cand_b, ev=ev_b)
        use_mq, km_q, mbits_q, maxd_qm, drop_q, segs_q = self._search_mask(
            an_b, self.base, recon_b, data_ref, target, qbase, bs_q, bits_q,
            feas_q, counts_b, ev=ev_b)
        _, km_pure, mbits_pure, _, _, segs_pure = self._search_mask(
            an_b, self.base, recon_b, data_ref, target, jnp.float32(0.0),
            bs_pure, bits_pure, feas_pure, counts_b, ev=ev_b)

        # the decoder's view of the base layer is the MASKED reconstruction
        # when the mask wins; the residual must be computed against it
        coef_q = self._recon_at(an_b, self.base, bs_q, ks_q)
        if self._mask_enabled(self.base):
            coef_q = jnp.where(use_mq[:, None, None],
                               bp.recon_masked(an_b, bs_q, drop_q,
                                               self.base.spec), coef_q)
            maxd_q = jnp.where(use_mq, maxd_qm, maxd_q)
        base_rec = recon_b(coef_q)
        resid = data_ref - base_rec
        skip_residual = maxd_q <= 0  # "Skip Residual 1" (j2k_codec.h:584)

        with jax.named_scope(SCOPE_RESID):
            rmin, rmax, dcr, cir = self._resid_transform(resid)
            an_r = bp.analyze(cir, self.resid.spec)

            def recon_r(rc):
                return base_rec + self._resid_recon(rc, rmin, rmax, dcr)

            counts_r = bp.segment_counts(an_r, self.resid.spec)
            ev_r = _Eval(an_r, self.resid, recon_r, data_ref, target)
            resid_bits, resid_feas, _, bs_r, ks_r = self._search_truncation(
                an_r, self.resid, recon_r, data_ref, target, jnp.float32(0.0),
                cand=bp.candidate_bits(counts_r, self.resid.spec), ev=ev_r)
            _, km_r, mbits_r, _, _, segs_r = self._search_mask(
                an_r, self.resid, recon_r, data_ref, target, jnp.float32(0.0),
                bs_r, resid_bits, resid_feas, counts_r, ev=ev_r)

            pb16, pb8, sb16, sb8, okb16, okb8 = self._pack_small(
                ci, an_b.max_step, jnp.minimum(bs_q, bs_pure))
            pr16, pr8, sr16, sr8, okr16, okr8 = self._pack_small(
                cir, an_r.max_step,
                jnp.where(skip_residual, self.resid.spec.nplanes, bs_r))
            spd, spv, nsig, oksp = self._sparsify(pb16, okb16)
            rspd, rspv, rnsig, roksp = self._sparsify(pr16, okr16,
                                                      self.resid_sparse_k)

        # coefficients travel to the host coder packed u8/u16 (or as
        # float32 — exact integers < 2**22 — when >15 planes are coded)
        return EncodeResult(
            mn=mn, mx=mx, const=const, dc_b=dc, max_step_b=an_b.max_step,
            base_coef=ci.astype(jnp.float32), base_bits_q=bits_q,
            base_bits_pure=bits_pure, base_feasible_pure=feas_pure,
            bs_q=bs_q, ks_q=ks_q, bs_pure=bs_pure, ks_pure=ks_pure,
            bs_r=bs_r, ks_r=ks_r,
            km_q=km_q, km_pure=km_pure, km_r=km_r,
            mbits_q=mbits_q, mbits_pure=mbits_pure, mbits_r=mbits_r,
            segs_q=segs_q, segs_pure=segs_pure, segs_r=segs_r,
            rmin=rmin, rmax=rmax, dc_r=dcr, max_step_r=an_r.max_step,
            resid_coef=cir.astype(jnp.float32), resid_bits=resid_bits,
            resid_feasible=resid_feas, skip_residual=skip_residual,
            base_pack16=pb16, resid_pack16=pr16,
            base_pack8=pb8, resid_pack8=pr8,
            base_shift=sb16, resid_shift=sr16,
            base_shift8=sb8, resid_shift8=sr8,
            base_pack16_ok=okb16, resid_pack16_ok=okr16,
            base_pack8_ok=okb8, resid_pack8_ok=okr8,
            base_sp_delta=spd, base_sp_val=spv, base_nsig=nsig,
            base_sparse_ok=oksp,
            resid_sp_delta=rspd, resid_sp_val=rspv, resid_nsig=rnsig,
            resid_sparse_ok=roksp)

    def _encode_error_bounded_multi(self, data, target, qs):
        """Evaluate K base-quantile candidates in ONE device call.

        ``qs``: [K] candidate feasibility quantiles.  The base transform,
        analysis, coarse plane scan and pure-base selection are computed
        once and shared; each candidate adds only its fine truncation
        scan and its residual layer.  Returns a list of K
        :class:`EncodeResult` whose base-layer arrays are the SAME device
        buffers (fetch them once).  This is the device side of the
        one-dispatch rate optimiser (models/rate_opt.py) that replaces
        the reference's sequential golden-section re-encodes
        (image_compression.py:499-567).
        """
        mn, mx, const, dc, ci = self._base_transform(data)
        return self._eb_multi_core(data, mn, mx, const, dc, ci, target, qs)

    def _encode_error_bounded_multi_hostq(self, u, mn, mx, target, qs):
        """Multi-quantile encode from host-quantised input (see
        :meth:`_encode_error_bounded_hostq` for the u16/target contract).

        Returns (results, packed): one packed-metadata array per candidate
        (each also carries the shared base-layer fields — candidates share
        those device buffers, so the duplication is K small transfers
        replacing ~40 + 29K individual leaf fetches)."""
        dataq, const, dc, ci = self._hostq_prelude(u, mn, mx)
        res_list = self._eb_multi_core(dataq, mn, mx, const, dc, ci,
                                       target, qs)
        return res_list, [self._pack_meta(r) for r in res_list]

    def _eb_multi_core(self, data_ref, mn, mx, const, dc, ci, target, qs):
        an_b = bp.analyze(ci, self.base.spec)

        def recon_b(rc):
            return self._base_recon(rc, mn, mx, dc)

        counts_b = bp.segment_counts(an_b, self.base.spec)
        cand_b = bp.candidate_bits(counts_b, self.base.spec)
        ev_b = _Eval(an_b, self.base, recon_b, data_ref, target)
        bits_pure, feas_pure, _, bs_pure, ks_pure = self._search_truncation(
            an_b, self.base, recon_b, data_ref, target, jnp.float32(0.0),
            cand=cand_b, ev=ev_b)
        _, km_pure, mbits_pure, _, _, segs_pure = self._search_mask(
            an_b, self.base, recon_b, data_ref, target, jnp.float32(0.0),
            bs_pure, bits_pure, feas_pure, counts_b, ev=ev_b)

        per_q = []
        bs_min = bs_pure
        for k in range(qs.shape[0]):
            bits_q, feas_q, maxd_q, bs_q, ks_q = self._search_truncation(
                an_b, self.base, recon_b, data_ref, target, qs[k],
                cand=cand_b, ev=ev_b)
            use_mq, km_q, mbits_q, maxd_qm, drop_q, segs_q = \
                self._search_mask(an_b, self.base, recon_b, data_ref, target,
                                  qs[k], bs_q, bits_q, feas_q, counts_b,
                                  ev=ev_b)
            coef_q = self._recon_at(an_b, self.base, bs_q, ks_q)
            if self._mask_enabled(self.base):
                coef_q = jnp.where(use_mq[:, None, None],
                                   bp.recon_masked(an_b, bs_q, drop_q,
                                                   self.base.spec), coef_q)
                maxd_q = jnp.where(use_mq, maxd_qm, maxd_q)
            base_rec = recon_b(coef_q)
            resid = data_ref - base_rec
            skip_residual = maxd_q <= 0
            rmin, rmax, dcr, cir = self._resid_transform(resid)
            an_r = bp.analyze(cir, self.resid.spec)

            def recon_r(rc, _b=base_rec, _rmin=rmin, _rmax=rmax, _dcr=dcr):
                return _b + self._resid_recon(rc, _rmin, _rmax, _dcr)

            counts_r = bp.segment_counts(an_r, self.resid.spec)
            ev_r = _Eval(an_r, self.resid, recon_r, data_ref, target)
            resid_bits, resid_feas, _, bs_r, ks_r = self._search_truncation(
                an_r, self.resid, recon_r, data_ref, target, jnp.float32(0.0),
                cand=bp.candidate_bits(counts_r, self.resid.spec), ev=ev_r)
            _, km_r, mbits_r, _, _, segs_r = self._search_mask(
                an_r, self.resid, recon_r, data_ref, target, jnp.float32(0.0),
                bs_r, resid_bits, resid_feas, counts_r, ev=ev_r)
            pr16, pr8, sr16, sr8, okr16, okr8 = self._pack_small(
                cir, an_r.max_step,
                jnp.where(skip_residual, self.resid.spec.nplanes, bs_r))
            rspd, rspv, rnsig, roksp = self._sparsify(
                pr16, okr16, self.resid_sparse_k)
            per_q.append(dict(
                resid_sp_delta=rspd, resid_sp_val=rspv, resid_nsig=rnsig,
                resid_sparse_ok=roksp,
                base_bits_q=bits_q, bs_q=bs_q, ks_q=ks_q, bs_r=bs_r,
                ks_r=ks_r, km_q=km_q, km_r=km_r, mbits_q=mbits_q,
                mbits_r=mbits_r, segs_q=segs_q, segs_r=segs_r,
                rmin=rmin, rmax=rmax, dc_r=dcr,
                max_step_r=an_r.max_step,
                resid_coef=cir.astype(jnp.float32), resid_bits=resid_bits,
                resid_feasible=resid_feas, skip_residual=skip_residual,
                resid_pack16=pr16, resid_pack8=pr8, resid_shift=sr16,
                resid_shift8=sr8, resid_pack16_ok=okr16,
                resid_pack8_ok=okr8))
            bs_min = jnp.minimum(bs_min, bs_q)

        # base transfer forms valid for EVERY candidate's truncation
        pb16, pb8, sb16, sb8, okb16, okb8 = self._pack_small(
            ci, an_b.max_step, bs_min)
        spd, spv, nsig, oksp = self._sparsify(pb16, okb16)
        shared = dict(
            mn=mn, mx=mx, const=const, dc_b=dc, max_step_b=an_b.max_step,
            base_coef=ci.astype(jnp.float32), base_bits_pure=bits_pure,
            base_feasible_pure=feas_pure, bs_pure=bs_pure, ks_pure=ks_pure,
            km_pure=km_pure, mbits_pure=mbits_pure, segs_pure=segs_pure,
            base_pack16=pb16, base_pack8=pb8, base_shift=sb16,
            base_shift8=sb8, base_pack16_ok=okb16, base_pack8_ok=okb8,
            base_sp_delta=spd, base_sp_val=spv, base_nsig=nsig,
            base_sparse_ok=oksp)
        return [EncodeResult(**shared, **pq) for pq in per_q]

    def _encode_rate_targeted(self, data, base_budget_bits, resid_budget_bits):
        """NONE / SPARSIFICATION_FACTOR encode: truncate at bit budgets.

        ``resid_budget_bits <= 0`` disables the residual layer (NONE mode).
        """
        mn, mx, const, dc, ci = self._base_transform(data)
        return self._rate_core(data, mn, mx, const, dc, ci,
                               base_budget_bits, resid_budget_bits)

    def _encode_rate_targeted_hostq(self, u, mn, mx, base_budget_bits,
                                    resid_budget_bits):
        """Rate-targeted encode from host-quantised input (no error
        criterion, so no target tightening is needed — the u16 transfer
        form is exact for the pipeline's own quantisation)."""
        dataq, const, dc, ci = self._hostq_prelude(u, mn, mx)
        res = self._rate_core(dataq, mn, mx, const, dc, ci,
                              base_budget_bits, resid_budget_bits)
        return res, self._pack_meta(res)

    def _rate_core(self, data_ref, mn, mx, const, dc, ci,
                   base_budget_bits, resid_budget_bits):
        an_b = bp.analyze(ci, self.base.spec)
        counts = bp.segment_counts(an_b, self.base.spec)
        cand = bp.candidate_bits(counts, self.base.spec)
        flat = cand.reshape(cand.shape[0], -1)
        fits = flat <= base_budget_bits[:, None]
        idx = jnp.sum(fits, axis=-1) - 1  # last fitting candidate
        idx = jnp.clip(idx, 0, flat.shape[-1] - 1)
        bits_b = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        nk = 2 * self.base.spec.nchunks
        bs = self.base.spec.nplanes - 1 - idx // nk
        ks = idx % nk

        base_rec = self._base_recon(self._recon_at(an_b, self.base, bs, ks),
                                    mn, mx, dc)
        resid = data_ref - base_rec
        rmin, rmax, dcr, cir = self._resid_transform(resid)
        an_r = bp.analyze(cir, self.resid.spec)
        counts_r = bp.segment_counts(an_r, self.resid.spec)
        cand_r = bp.candidate_bits(counts_r, self.resid.spec).reshape(
            cand.shape[0], -1)
        fits_r = cand_r <= resid_budget_bits[:, None]
        idx_r = jnp.clip(jnp.sum(fits_r, axis=-1) - 1, 0,
                         cand_r.shape[-1] - 1)
        bits_r = jnp.take_along_axis(cand_r, idx_r[:, None], axis=1)[:, 0]
        use_resid = resid_budget_bits > 0
        nk_r = 2 * self.resid.spec.nchunks
        bs_r = self.resid.spec.nplanes - 1 - idx_r // nk_r
        ks_r = idx_r % nk_r

        pb16, pb8, sb16, sb8, okb16, okb8 = self._pack_small(
            ci, an_b.max_step, bs)
        pr16, pr8, sr16, sr8, okr16, okr8 = self._pack_small(
            cir, an_r.max_step,
            jnp.where(use_resid, bs_r, self.resid.spec.nplanes))
        spd, spv, nsig, oksp = self._sparsify(pb16, okb16)
        rspd, rspv, rnsig, roksp = self._sparsify(pr16, okr16,
                                                  self.resid_sparse_k)

        # rate-targeted modes have no error criterion to mask against:
        # streams stay pure prefixes (km = -1)
        nb = mn.shape[0]
        noseg = jnp.zeros((nb, 2 + 2 * self.base.spec.nchunks), jnp.int32)
        nokm = jnp.full(nb, -1, jnp.int32)
        return EncodeResult(
            mn=mn, mx=mx, const=const, dc_b=dc, max_step_b=an_b.max_step,
            base_coef=ci.astype(jnp.float32), base_bits_q=bits_b,
            base_bits_pure=bits_b, base_feasible_pure=jnp.zeros_like(const),
            bs_q=bs, ks_q=ks, bs_pure=bs, ks_pure=ks, bs_r=bs_r, ks_r=ks_r,
            km_q=nokm, km_pure=nokm, km_r=nokm,
            mbits_q=jnp.asarray(bits_b, jnp.int32),
            mbits_pure=jnp.asarray(bits_b, jnp.int32),
            mbits_r=jnp.asarray(jnp.where(use_resid, bits_r, 0), jnp.int32),
            segs_q=noseg, segs_pure=noseg, segs_r=noseg,
            rmin=rmin, rmax=rmax, dc_r=dcr, max_step_r=an_r.max_step,
            resid_coef=cir.astype(jnp.float32),
            resid_bits=jnp.where(use_resid, bits_r, 0),
            resid_feasible=use_resid, skip_residual=~use_resid,
            base_pack16=pb16, resid_pack16=pr16,
            base_pack8=pb8, resid_pack8=pr8,
            base_shift=sb16, resid_shift=sr16,
            base_shift8=sb8, resid_shift8=sr8,
            base_pack16_ok=okb16, resid_pack16_ok=okr16,
            base_pack8_ok=okb8, resid_pack8_ok=okr8,
            base_sp_delta=spd, base_sp_val=spv, base_nsig=nsig,
            base_sparse_ok=oksp,
            resid_sp_delta=rspd, resid_sp_val=rspv, resid_nsig=rnsig,
            resid_sparse_ok=roksp)

    # ---------------- decode stages ----------------

    def _recon_stage(self, coef_b, mn, mx, dc, has_resid, coef_r,
                     rmin, rmax, dcr):
        """Dequantise + inverse transform from float coefficient planes
        (the structural bitstream decode happens in the native host coder,
        native/ebcc_coder.cc)."""
        out = self._base_recon(coef_b, mn, mx, dc)
        resid = self._resid_recon(coef_r, rmin, rmax, dcr)
        return out + jnp.where(has_resid[:, None, None], resid, 0.0)

    @staticmethod
    def _unpack16_coef(v16, bend):
        """Inverse of the native u16 decode packing: sign<<15 | last_off<<14
        | (mag >> b_end) -> float midpoint coefficients."""
        v = v16.astype(jnp.int32)
        mag = (v & 0x3FFF) << bend[:, None, None]
        last = bend[:, None, None] + ((v >> 14) & 1)
        half = jnp.where((mag > 0) & (last > 0),
                         (jnp.exp2(last.astype(jnp.float32)) - 1.0) * 0.5,
                         0.0)
        rec = jnp.where(mag > 0, mag.astype(jnp.float32) + half, 0.0)
        return jnp.where((v & 0x8000) != 0, -rec, rec)  # bit 15 = sign

    def _recon_packed_stage(self, v16_b, bend_b, mn, mx, dc, has_resid,
                            v16_r, bend_r, rmin, rmax, dcr):
        return self._recon_stage(self._unpack16_coef(v16_b, bend_b),
                                 mn, mx, dc, has_resid,
                                 self._unpack16_coef(v16_r, bend_r),
                                 rmin, rmax, dcr)

    def _decode_stage(self, base_words, base_bits, max_step_b, mn, mx, dc,
                      has_resid, resid_words, resid_bits, max_step_r,
                      rmin, rmax, dcr, mask_b=None, keep_b=None,
                      mask_r=None, keep_r=None):
        """Pure-JAX decode path (fallback + the all-device dryrun path).
        ``mask_*``/``keep_*`` [B]: format-v4 chunk masks (-1 = none)."""
        rc = bp.decode_batch(base_words, base_bits, max_step_b,
                             self.base.spec, mask_plane=mask_b,
                             keep_mask=keep_b)
        rr = bp.decode_batch(resid_words, resid_bits, max_step_r,
                             self.resid.spec, mask_plane=mask_r,
                             keep_mask=keep_r)
        return self._recon_stage(rc, mn, mx, dc, has_resid, rr,
                                 rmin, rmax, dcr)

    # ---------------- public (device-level) API ----------------

    def encode_error_bounded(self, data, target, qbase):
        return self._encode_eb(data, target, jnp.float32(qbase))

    def encode_error_bounded_multi(self, data, target, qs):
        """K quantile candidates in one jitted dispatch (see
        :meth:`_encode_error_bounded_multi`)."""
        return self._encode_eb_multi(data, target,
                                     jnp.asarray(qs, jnp.float32))

    def encode_rate_targeted(self, data, base_budget_bits, resid_budget_bits):
        return self._encode_rate(data, base_budget_bits, resid_budget_bits)

    def encode_error_bounded_hostq(self, u, mn, mx, target, qbase):
        """Host-quantised entry: u16 frames + host ranges + pre-tightened
        targets (see :meth:`_encode_error_bounded_hostq`)."""
        return self._encode_eb_hostq(u, mn, mx, target, jnp.float32(qbase))

    def encode_error_bounded_multi_hostq(self, u, mn, mx, target, qs):
        return self._encode_eb_multi_hostq(u, mn, mx, target,
                                           jnp.asarray(qs, jnp.float32))

    def encode_rate_targeted_hostq(self, u, mn, mx, base_budget_bits,
                                   resid_budget_bits):
        return self._encode_rate_hostq(u, mn, mx, base_budget_bits,
                                       resid_budget_bits)

    def decode(self, *args):
        """Decode from packed word buffers (pure-JAX path)."""
        return self._decode(*args)

    def recon(self, *args):
        """Reconstruct frames from structurally-decoded coefficients."""
        return self._recon(*args)

    def recon_packed(self, *args):
        """Reconstruct frames from the native coder's packed u16 state."""
        return self._recon_packed(*args)
