"""Pointwise-bounded bytes-in/bytes-out compressor with a hard guarantee.

Batched device equivalent of ``EBCCDirectWrapper``
(/root/reference/ebcc_wrapper/direct_wrapper.py:40-151).  The reference
stacks [data, error_bound], round-trips a tempfile HDF5 with filter 310,
then appends an exact-value patch for any points still violating
``eb * ratio``.  Here the array goes straight through the pointwise codec
(no tempfile, no HDF5), and the same exact-patch safety net makes the
per-point bound *unconditional*:

    |decompress(compress(x, eb))[i] - x[i]| <= eb[i] * ratio   for all i.

The patch encodes the violating index set every applicable way — bitmask,
vbyte position deltas, u32 indices, block-coded, u16 overflow-deltas (the
stack-B candidate families, image_compression.py:138-276) — and keeps the
smallest, plus the exact float32 values, entropy-packed with zstd
(direct_wrapper.py:85-100 keeps min(bitmask, indices) the same way).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from ..utils import logging as elog

_MAGIC = b"EBTD"    # legacy (round <= 2): no reconstruction-backend record
_MAGIC_E = b"EBTE"  # current: header carries the reconstruction backend

# EBTE backend codes.  The exact-value patch is computed against ONE
# decoder's reconstruction; the two decode backends agree only to ~1e-3
# in data units (config.py), so decoding a blob with the OTHER backend
# can push a near-threshold unpatched point past the pointwise bound.
# The blob therefore records which decoder its patch was built against
# and decompress() honours it, failing loudly rather than silently
# reconstructing with whichever backend this host happens to have.
_BACKEND_CODES = {"cpu": 1, "device": 2}
_BACKEND_NAMES = {v: k for k, v in _BACKEND_CODES.items()}


def _pack(data: bytes, level: int = 9) -> bytes:
    return api._zstd_compress(data, level)


def _unpack(data: bytes, max_size: int) -> bytes:
    return api._zstd_decompress(data, max_size)


class DirectCompressor:
    """Array-in/bytes-out pointwise compressor with hard bound guarantee.

    Parameters mirror ``EBCCDirectWrapper.__init__``
    (direct_wrapper.py:23-38): ``base_cr`` seeds the base layer rate,
    ``ratio`` scales the user bound before enforcement (the codec targets
    ``eb * ratio`` so the *user* bound holds with margin).
    """

    def __init__(self, base_cr: float = 100.0, ratio: float = 1.0,
                 config: EBCCConfig | None = None, rate_candidates=None):
        import dataclasses

        self.ratio = float(ratio)
        # per-slice rate optimisation: sweep these base-quantile candidates
        # (one pipelined multi-q dispatch, models/rate_opt.py engine) and
        # keep, per slice, the smallest TOTAL encoding including the
        # exact-value patch — the role of the per-slice golden-section
        # search in the reference's delta codec
        # (image_compression_delta.py:63-75 optimises every slice;
        # selection includes fail values, delta_compression.py:301-389).
        self.rate_candidates = (tuple(float(q) for q in rate_candidates)
                                if rate_candidates else None)
        self.config = config or EBCCConfig(
            mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=base_cr,
            pointwise_max_error_ratio=ratio)
        if self.config.decode_backend == "auto":
            # the exact-value patch is computed against decompress()'s
            # reconstruction, so compress and EVERY later decompress must
            # reconstruct identically — the device recon's last bits
            # depend on the compiler and device, which would let a
            # near-threshold unpatched point drift past the bound.  Pin
            # the deterministic backend: the native CPU decoder (bit-stable
            # across hosts, the role the reference's C library plays).
            self.config = dataclasses.replace(self.config,
                                              decode_backend="cpu")

    # -- patch encoding (direct_wrapper.py:85-100) --------------------------
    # Like the reference's stack-B failure coding (image_compression.py:
    # 138-276 tries 7 encodings — full / idx+val / bitmask+val / block-id /
    # adaptive delta / overflow-delta / vbyte — and keeps the smallest),
    # the index set is encoded every applicable way and the smallest wins:
    #   0  i64 indices            (kept for decoding old blobs)
    #   1  bitmask over npoints   (bitmask+val analogue)
    #   2  varint position deltas (vbyte / adaptive-delta analogue; the
    #                              typical winner when sparse)
    #   3  u32 indices            (idx+val analogue)
    #   4  block-coded            (block-id analogue: varint block deltas +
    #                              varint per-block counts + u8 offsets)
    #   5  u16 overflow deltas    (overflow-delta analogue: u16 gaps with a
    #                              0xFFFF escape to a u32 side array)
    # The reference's "full" candidate (the whole quantised residual plane)
    # is covered by the codec's residual layer itself, not the patch.
    # Values are always exact f32; the chosen payload is zstd-packed.

    _BLOCK_SHIFT = 8  # method-4 block size (256 points per block)

    @staticmethod
    def _varint_encode(arr: np.ndarray) -> bytes:
        """Vectorised vbyte: per-value byte lengths via shift passes, then
        one masked scatter per byte position (no Python-per-value loop)."""
        v = np.asarray(arr, np.uint64)
        n = len(v)
        if n == 0:
            return b""
        bl = np.ones(n, np.int64)
        tmp = v >> np.uint64(7)
        while tmp.any():
            bl += tmp > 0
            tmp >>= np.uint64(7)
        ends = np.cumsum(bl)
        starts = ends - bl
        out = np.zeros(int(ends[-1]), np.uint8)
        for k in range(int(bl.max())):
            sel = bl > k
            byte = ((v[sel] >> np.uint64(7 * k)) &
                    np.uint64(0x7F)).astype(np.uint8)
            cont = (bl[sel] - 1 > k).astype(np.uint8) << 7
            out[starts[sel] + k] = byte | cont
        return out.tobytes()

    @staticmethod
    def _varint_decode(buf: bytes, count: int):
        """Decode ``count`` varints; returns (values, bytes consumed)."""
        if count == 0:
            return np.zeros(0, np.int64), 0
        b = np.frombuffer(buf, np.uint8)
        ends = np.nonzero((b & 0x80) == 0)[0]
        if len(ends) < count:
            raise ValueError("truncated varint patch stream")
        ends = ends[:count]
        starts = np.concatenate([[0], ends[:-1] + 1])
        out = np.zeros(count, np.uint64)
        for k in range(int((ends - starts).max()) + 1):
            sel = starts + k <= ends
            out[sel] |= ((b[starts[sel] + k].astype(np.uint64) &
                          np.uint64(0x7F)) << np.uint64(7 * k))
        return out.astype(np.int64), int(ends[-1]) + 1

    @classmethod
    def _encode_block(cls, fail_idx: np.ndarray) -> bytes:
        """Method 4: two-level block coding of a sorted index set."""
        blocks = fail_idx >> cls._BLOCK_SHIFT
        offs = (fail_idx & ((1 << cls._BLOCK_SHIFT) - 1)).astype(np.uint8)
        ublocks, counts = np.unique(blocks, return_counts=True)
        bdeltas = np.diff(ublocks, prepend=0) if len(ublocks) else ublocks
        head = struct.pack("<I", len(ublocks))
        return (head + cls._varint_encode(bdeltas) +
                cls._varint_encode(counts) + offs.tobytes())

    @classmethod
    def _decode_block(cls, payload: bytes, nfail: int) -> np.ndarray:
        (nblocks,) = struct.unpack_from("<I", payload, 0)
        b = payload[4:]
        bdeltas, used = cls._varint_decode(b, nblocks)
        counts, used2 = cls._varint_decode(b[used:], nblocks)
        offs = np.frombuffer(b[used + used2:used + used2 + nfail], np.uint8)
        if int(counts.sum()) != nfail or len(offs) != nfail:
            raise ValueError("corrupt block-coded patch stream")
        blocks = np.repeat(np.cumsum(bdeltas), counts)
        return (blocks << cls._BLOCK_SHIFT) | offs.astype(np.int64)

    @staticmethod
    def _encode_overflow(deltas: np.ndarray) -> bytes:
        """Method 5: u16 gaps, 0xFFFF escaping to a u32 side array."""
        small = deltas < 0xFFFF
        g16 = np.where(small, deltas, 0xFFFF).astype(np.uint16)
        g32 = deltas[~small].astype(np.uint32)
        return g16.tobytes() + g32.tobytes()

    @staticmethod
    def _decode_overflow(payload: bytes, nfail: int) -> np.ndarray:
        g16 = np.frombuffer(payload[:2 * nfail], np.uint16)
        if len(g16) != nfail:
            raise ValueError("truncated overflow-delta patch stream")
        esc = g16 == 0xFFFF
        g32 = np.frombuffer(payload[2 * nfail:2 * nfail + 4 * int(esc.sum())],
                            np.uint32)
        if len(g32) != int(esc.sum()):
            raise ValueError("truncated overflow-delta patch stream")
        deltas = g16.astype(np.int64)
        deltas[esc] = g32
        return np.cumsum(deltas)

    @classmethod
    def _encode_patch(cls, fail_idx: np.ndarray, values: np.ndarray,
                      npoints: int) -> bytes:
        fail_idx = np.asarray(fail_idx, np.int64)
        mask = np.zeros(npoints, bool)
        mask[fail_idx] = True
        deltas = np.diff(fail_idx, prepend=0) if len(fail_idx) else fail_idx
        candidates = {
            1: np.packbits(mask).tobytes(),
            2: cls._varint_encode(deltas),
            4: cls._encode_block(fail_idx),
        }
        if len(deltas) == 0 or int(deltas.max()) <= 0xFFFFFFFF:
            # the u32 overflow side array would wrap on larger gaps
            candidates[5] = cls._encode_overflow(deltas)
        if npoints <= 1 << 32:  # u32 indices would wrap beyond this
            candidates[3] = fail_idx.astype(np.uint32).tobytes()
        method, enc = min(candidates.items(), key=lambda kv: len(kv[1]))
        blob = _pack(enc + values.astype(np.float32).tobytes())
        return struct.pack("<BII", method, len(fail_idx), len(blob)) + blob

    @classmethod
    def _decode_patch(cls, buf: bytes, off: int, npoints: int):
        method, nfail, blen = struct.unpack_from("<BII", buf, off)
        off += struct.calcsize("<BII")
        # untrusted header: nfail bounds the decompress allocation, so an
        # oversized value must not become a multi-GB np.empty
        if nfail > npoints or blen > len(buf) - off:
            raise ValueError("corrupt patch header")
        max_raw = {0: 8 * nfail, 1: (npoints + 7) // 8,
                   2: 9 * nfail, 3: 4 * nfail,
                   4: 4 + 19 * nfail, 5: 6 * nfail}[method]
        payload = _unpack(buf[off:off + blen], max_raw + 4 * nfail)
        off += blen
        raw_len = len(payload) - 4 * nfail
        if method == 0:
            idx = np.frombuffer(payload[:raw_len], np.int64)
        elif method == 1:
            bits = np.unpackbits(
                np.frombuffer(payload[:raw_len], np.uint8))[:npoints]
            idx = np.nonzero(bits)[0]
        elif method == 2:
            idx = np.cumsum(cls._varint_decode(payload[:raw_len], nfail)[0])
        elif method == 4:
            idx = cls._decode_block(payload[:raw_len], nfail)
        elif method == 5:
            idx = cls._decode_overflow(payload[:raw_len], nfail)
        else:
            idx = np.frombuffer(payload[:raw_len], np.uint32).astype(np.int64)
        vals = np.frombuffer(payload[raw_len:raw_len + 4 * nfail], np.float32)
        idx = np.asarray(idx, np.int64)
        if len(idx) != nfail or len(vals) != nfail or (
                len(idx) and (int(idx.min()) < 0 or
                              int(idx.max()) >= npoints)):
            # out-of-range indices in a corrupt patch would silently write
            # through numpy negative-index wraparound
            raise ValueError("corrupt patch stream (index out of range)")
        return idx, vals, off

    # -- public API ----------------------------------------------------------

    def _assemble(self, data, eb, blob, rec):
        """Patch + frame a core container blob; returns (blob, rec) where
        ``rec`` is EXACTLY what :meth:`decompress` will reconstruct (the
        chain compressors rely on this to keep encoder and decoder state
        identical)."""
        err = np.abs(rec - data)
        fail = err > eb * self.ratio
        fail_idx = np.nonzero(fail.reshape(-1))[0]
        elog.debug("DirectCompressor: %d/%d points patched",
                   len(fail_idx), data.size)
        vals = data.reshape(-1)[fail_idx]
        patch = self._encode_patch(fail_idx, vals, data.size)
        backend = _BACKEND_CODES[self.config.decode_backend]
        head = struct.pack("<4sBBQ", _MAGIC_E, backend, len(data.shape),
                           len(blob))
        dims = struct.pack(f"<{len(data.shape)}I", *data.shape)
        rec = np.array(rec, copy=True)
        rec.reshape(-1)[fail_idx] = vals
        return head + dims + blob + patch, rec

    def compress(self, data, error_bound) -> bytes:
        """Compress [..., H, W] float32 against a per-point bound array
        (same shape, or scalar).  Returns a self-describing blob."""
        return self.compress_with_rec(data, error_bound)[0]

    def compress_with_rec(self, data, error_bound):
        """Compress and also return the decoder-exact reconstruction.

        The reconstruction equals ``decompress(blob)`` bit for bit — the
        codec already computes it for the exact-value patch, so chain
        compressors (delta/predictive) get the decoder state without a
        second decode round trip.
        """
        data = np.asarray(data, np.float32)
        if self.rate_candidates:
            return self.compress_batch(data[None],
                                       np.asarray(error_bound,
                                                  np.float32)[None])[0]
        eb = np.broadcast_to(np.asarray(error_bound, np.float32),
                             data.shape).copy()
        if np.any(eb <= 0):
            raise ValueError("error_bound must be positive everywhere")
        blob = api.compress(data, self.config, error_bound=eb)
        rec = api.decompress(blob, self.config).reshape(data.shape)
        return self._assemble(data, eb, blob, rec)

    def compress_batch(self, datas, error_bounds):
        """Compress L independent slices in ONE batched device pipeline.

        ``datas``/``error_bounds``: [L, ..., H, W].  Returns a list of
        L ``(blob, rec)`` pairs, each identical to what
        :meth:`compress_with_rec` returns for that slice — but the
        transform/search/packing runs as one pipelined ``api.compress``
        over all L*frames frames instead of L separate dispatch chains
        (the batching the reference gets from its process pools,
        delta_compression.py:223-245)."""
        from ..codec import container as _c
        datas = np.asarray(datas, np.float32)
        ebs = np.broadcast_to(
            np.asarray(error_bounds, np.float32), datas.shape).copy()
        if np.any(ebs <= 0):
            raise ValueError("error_bound must be positive everywhere")
        nslices = datas.shape[0]
        slice_shape = datas.shape[1:]
        fps = int(np.prod(slice_shape[:-2], dtype=np.int64))  # frames/slice
        if self.rate_candidates:
            return self._compress_batch_multi_q(datas, ebs, nslices, fps)
        blob_all = api.compress(datas, self.config, error_bound=ebs)
        rec_all = api.decompress(blob_all, self.config).reshape(datas.shape)
        frames = _c.unpack_blob(blob_all)
        out = []
        for i in range(nslices):
            sub = _c.pack_blob(frames[i * fps:(i + 1) * fps])
            out.append(self._assemble(datas[i], ebs[i], sub, rec_all[i]))
        return out

    def _compress_batch_multi_q(self, datas, ebs, nslices, fps):
        """Per-slice rate optimisation over ``rate_candidates``.

        One pipelined ``compress_multi_q`` dispatch encodes every slice
        under every quantile candidate (the base transform/analysis/arena
        are shared across candidates), one batched decompress reconstructs
        all of them, and each slice keeps the candidate whose TOTAL size —
        core stream plus exact-value patch — is smallest.  This is the
        per-slice golden-section optimisation of the reference's delta
        codec (image_compression_delta.py:63-75; size comparison includes
        fail values as in delta_compression.py:301-389) collapsed into two
        device dispatch chains for the whole stack.
        """
        from ..codec import container as _c
        qs = self.rate_candidates
        blobs_q = api.compress_multi_q(datas, qs, self.config,
                                       error_bound=ebs)
        frames_q = [_c.unpack_blob(b) for b in blobs_q]
        # one batched decode covers every candidate's reconstruction
        rec_all = api.decompress(
            _c.pack_blob([f for fq in frames_q for f in fq]),
            self.config).reshape((len(qs),) + datas.shape)
        out = []
        for i in range(nslices):
            best = None
            for k in range(len(qs)):
                sub = _c.pack_blob(frames_q[k][i * fps:(i + 1) * fps])
                cand = self._assemble(datas[i], ebs[i], sub, rec_all[k, i])
                if best is None or len(cand[0]) < len(best[0]):
                    best = cand
            out.append(best)
        return out

    def decompress(self, blob: bytes) -> np.ndarray:
        import dataclasses

        from ..runtime import native as _native
        config = self.config
        if blob[:4] == _MAGIC_E:
            magic, backend_code, ndim, blen = struct.unpack_from(
                "<4sBBQ", blob, 0)
            off = struct.calcsize("<4sBBQ")
            backend = _BACKEND_NAMES.get(backend_code)
            if backend is None:
                raise ValueError(
                    f"unknown reconstruction backend {backend_code} in "
                    "DirectCompressor blob")
            if backend == "cpu" and not _native.HAVE_NATIVE:
                raise RuntimeError(
                    "this blob's exact-value patch was built against the "
                    "native CPU decoder; decoding it with another backend "
                    "can violate the pointwise bound.  Build the native "
                    "runtime: make -C native")
            if backend != config.decode_backend:
                config = dataclasses.replace(config, decode_backend=backend)
        elif blob[:4] == _MAGIC:
            # legacy blob (no backend record): decode with this machine's
            # pinned backend, as before
            magic, ndim, blen = struct.unpack_from("<4sBQ", blob, 0)
            off = struct.calcsize("<4sBQ")
        else:
            raise ValueError("not a DirectCompressor blob")
        shape = struct.unpack_from(f"<{ndim}I", blob, off)
        off += 4 * ndim
        rec = api.decompress(blob[off:off + blen], config)
        off += blen
        rec = rec.reshape(shape)
        flat = rec.reshape(-1)
        idx, vals, _ = self._decode_patch(blob, off, flat.size)
        flat[idx] = vals  # exact-value patch (direct_wrapper.py:126-151)
        return flat.reshape(shape)
