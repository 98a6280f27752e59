"""Serialized container format (versioned).

Functional equivalent of the reference container (written
/root/reference/src/j2k_codec.h:706-736, parsed :1098-1112), redesigned: the
byte layout differs (this codec's bitstreams are not OpenJPEG/SPIHT streams)
but the field set is a superset — min/max, residual min/max, stream sizes,
constant-field short form — plus the header metadata the device decoder needs
(DC offsets, top bitplanes, truncation points).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

MAGIC = b"EBT1"

FLAG_CONST = 1
FLAG_RESID = 2
FLAG_POINTWISE = 4
FLAG_BASE_Z = 8     # base bitstream is zstd-compressed (raw size from
                    # base_nbits)

_HDR3 = struct.Struct("<4sBBHII ff fI B BBBBB")   # v3 fixed part
_HDR = struct.Struct("<4sBBHII ff fI B BBBBB BH")  # v4: + mask_plane, keep
_RES3 = struct.Struct("<fffBIQ")                   # v3 residual part
_RES = struct.Struct("<fffBIQBH")                  # v4: + mask_plane, keep
# fields: magic, version, flags, mode, h, w | mn, mx | dc_b, base_nbits,
# max_step_b | base_levels, resid_levels, nchunks, base_nplanes,
# resid_nplanes | base_mask_plane, base_keep_mask ; residual: rmin, rmax,
# dc_r, max_step_r, resid_nbits, zlen, resid_mask_plane, resid_keep_mask
#
# The coder-geometry fields make frames self-describing: the bitstream
# layout depends on them, so a decoder must not rely on its own config
# defaults matching the encoder's.
#
# Version history: 2 = round-1 streams (unquantised synthesis-peak
# weights); 3 = weight tables quantised to the 1/1024 grid
# (docs/FORMAT.md) — the weights are part of the stream semantics, so
# decoding a v2 stream with v3 weights would silently shift the
# reconstruction; the version byte rejects the mix instead; 4 = chunk-
# masked last-plane truncation (per-layer mask_plane + keep_mask header
# fields; MASK_NONE = no masking).  v4 readers accept v3 streams.

VERSION = 4
MASK_NONE = 0xFF  # mask_plane sentinel: layer is a pure prefix (no mask)


class FrameHeader(NamedTuple):
    flags: int
    mode: int
    h: int
    w: int
    mn: float
    mx: float
    dc_b: float
    base_nbits: int
    max_step_b: int
    base_levels: int
    resid_levels: int
    nchunks: int
    base_nplanes: int
    resid_nplanes: int
    rmin: float
    rmax: float
    dc_r: float
    max_step_r: int
    resid_nbits: int
    zlen: int
    base_mask_plane: int = MASK_NONE
    base_keep_mask: int = 0
    resid_mask_plane: int = MASK_NONE
    resid_keep_mask: int = 0


def pack_frame(mode: int, h: int, w: int, mn: float, mx: float, *,
               const: bool = False, tot_size: int = 0,
               dc_b: float = 0.0, base_nbits: int = 0, max_step_b: int = 0,
               base_stream: bytes = b"", base_z: bool = False,
               geom: tuple = (0, 0, 0, 0, 0),
               resid: tuple | None = None, pointwise: bool = False,
               base_mask: tuple = (MASK_NONE, 0)) -> bytes:
    """Serialize one frame.  ``resid`` = (rmin, rmax, dc_r, max_step_r,
    resid_nbits, zstd_blob[, mask_plane, keep_mask]) or None.  ``base_z``:
    base_stream bytes are zstd-compressed.  ``geom`` = (base_levels,
    resid_levels, nchunks, base_nplanes, resid_nplanes) — the coder geometry
    the streams were produced with.  ``base_mask`` = (mask_plane, keep_mask)
    for the chunk-masked final plane of the base layer (format v4);
    (MASK_NONE, 0) means the stream is a pure prefix."""
    flags = (FLAG_CONST if const else 0) | (FLAG_POINTWISE if pointwise else 0)
    if base_z:
        flags |= FLAG_BASE_Z
    if resid is not None:
        flags |= FLAG_RESID
    if const:
        head = _HDR.pack(MAGIC, VERSION, flags, mode, h, w, mn, mx, 0.0, 0,
                         0, *geom, MASK_NONE, 0)
        return head + struct.pack("<Q", tot_size)
    head = _HDR.pack(MAGIC, VERSION, flags, mode, h, w, mn, mx,
                     dc_b, base_nbits, max_step_b, *geom, *base_mask)
    parts = [head]
    if resid is not None:
        rmin, rmax, dc_r, max_step_r, resid_nbits, zblob = resid[:6]
        rmask = resid[6:] if len(resid) > 6 else (MASK_NONE, 0)
        parts.append(_RES.pack(rmin, rmax, dc_r, max_step_r, resid_nbits,
                               len(zblob), *rmask))
        parts.append(zblob)
    parts.append(base_stream)
    return b"".join(parts)


def unpack_frame(buf: bytes):
    """Parse one frame (format v3 or v4); returns (header: FrameHeader,
    zblob, base_stream, tot_size)."""
    if len(buf) < _HDR3.size or buf[:4] != MAGIC:
        raise ValueError("not an EBCC-TPU frame")
    ver = buf[4]
    if ver not in (3, VERSION):
        raise ValueError(f"unsupported EBCC-TPU frame version {ver}")
    hdr_s, res_s = (_HDR, _RES) if ver == VERSION else (_HDR3, _RES3)
    if len(buf) < hdr_s.size:
        raise ValueError("not an EBCC-TPU frame")
    fields = hdr_s.unpack_from(buf, 0)
    (magic, _, flags, mode, h, w, mn, mx, dc_b, base_nbits, max_step_b,
     bl, rl, nc, bp_, rp) = fields[:16]
    bmp, bkeep = fields[16:] if ver == VERSION else (MASK_NONE, 0)
    off = hdr_s.size
    if flags & FLAG_CONST:
        (tot,) = struct.unpack_from("<Q", buf, off)
        hdr = FrameHeader(flags, mode, h, w, mn, mx, 0.0, 0, 0,
                          bl, rl, nc, bp_, rp, 0.0, 0.0, 0.0, 0, 0, 0)
        return hdr, b"", b"", tot
    rmin = rmax = dc_r = 0.0
    max_step_r = resid_nbits = zlen = 0
    rmp, rkeep = MASK_NONE, 0
    zblob = b""
    if flags & FLAG_RESID:
        rfields = res_s.unpack_from(buf, off)
        rmin, rmax, dc_r, max_step_r, resid_nbits, zlen = rfields[:6]
        if ver == VERSION:
            rmp, rkeep = rfields[6:]
        off += res_s.size
        zblob = buf[off:off + zlen]
        off += zlen
    base_stream = buf[off:]
    hdr = FrameHeader(flags, mode, h, w, mn, mx, dc_b, base_nbits,
                      max_step_b, bl, rl, nc, bp_, rp,
                      rmin, rmax, dc_r, max_step_r, resid_nbits, zlen,
                      bmp, bkeep, rmp, rkeep)
    return hdr, zblob, base_stream, 0


def pack_blob(frames: list) -> bytes:
    """Concatenate per-frame containers with an index table."""
    head = struct.pack("<4sI", b"EBTB", len(frames))
    lens = struct.pack(f"<{len(frames)}Q", *[len(f) for f in frames])
    return head + lens + b"".join(frames)


def unpack_blob(blob: bytes) -> list:
    if len(blob) < 8 or blob[:4] != b"EBTB":
        raise ValueError("not an EBCC-TPU blob")
    magic, n = struct.unpack_from("<4sI", blob, 0)
    off = 8
    lens = struct.unpack_from(f"<{n}Q", blob, off)
    off += 8 * n
    out = []
    for ln in lens:
        out.append(blob[off:off + ln])
        off += ln
    return out
