"""Delta-chain compression along time or pressure-level axes.

Batched device equivalent of the reference's two delta compressors:

* ``PressureLevelDeltaCompressor`` (/root/reference/ebcc_wrapper/
  delta_compression.py:280-432): level 0 direct; level i compresses the
  prediction residual ``x_i - x_hat_{i-1}`` against level i's own bound and
  keeps ``min(delta, direct)`` per level; the decoder walks levels in order.
* ``DeltaErrorBoundedJP2KCodec`` (/root/reference/ebcc_wrapper/
  image_compression_delta.py:22-141): the same scheme along the time axis.

Both are one class here, parameterised by the chain axis.  Each slice goes
through :class:`~ebcc_tpu.models.direct.DirectCompressor`, whose exact-value
patch gives a *hard* per-point bound — which is what keeps the chain stable:
the decoder's accumulated state equals the encoder's by construction.

The slices of a chain are sequentially dependent (slice i needs the decoded
slice i-1), the reference's only "sequence-parallel"-shaped structure
(SURVEY.md §2.4).  Independent chains (variables, ensemble members) remain
embarrassingly parallel and should be spread over hosts/chips by the caller.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils import logging as elog
from .direct import DirectCompressor

_MAGIC = b"EBTC"


class DeltaCompressor:
    """min(delta, direct) chain compressor over the leading axis.

    ``data`` is [L, ...]: L chain slices (pressure levels or time steps).
    """

    def __init__(self, base_cr: float = 100.0, ratio: float = 1.0,
                 direct: DirectCompressor | None = None,
                 rate_candidates=None):
        """``rate_candidates``: optional base-quantile candidates; when
        set, every direct pass AND every delta probe is rate-optimised
        per slice (the reference golden-section-optimises each delta
        slice, image_compression_delta.py:63-75)."""
        if direct is not None and rate_candidates is not None:
            raise ValueError(
                "pass rate_candidates to the DirectCompressor itself when "
                "providing one explicitly (it would be silently ignored)")
        self.direct = direct or DirectCompressor(
            base_cr=base_cr, ratio=ratio, rate_candidates=rate_candidates)

    def compress(self, data, error_bound) -> bytes:
        """Compress [L, ..., H, W] against per-point (or scalar) bounds.

        Per slice, both the direct encoding and the delta-from-previous-
        reconstruction encoding are measured and the smaller kept
        (delta_compression.py:301-389).

        The L direct passes are independent and run as ONE batched device
        pipeline (``DirectCompressor.compress_batch``); only the delta
        probes are sequential (slice i's residual needs the decoder-exact
        reconstruction of slice i-1, which depends on the choice there).
        Each probe returns its reconstruction from the encode itself, so
        no slice ever pays a separate decompress round trip.
        """
        data = np.asarray(data, np.float32)
        eb = np.broadcast_to(np.asarray(error_bound, np.float32),
                             data.shape)
        nlev = data.shape[0]
        # one batched dispatch chain for ALL direct passes
        direct = self.direct.compress_batch(data, eb)
        parts = []
        prev_rec = None
        n_delta = 0
        for i in range(nlev):
            direct_blob, direct_rec = direct[i]
            if prev_rec is None:
                chosen, is_delta, rec = direct_blob, False, direct_rec
            else:
                resid = data[i] - prev_rec
                delta_blob, delta_rec = self.direct.compress_with_rec(
                    resid, eb[i])
                if len(delta_blob) < len(direct_blob):
                    chosen, is_delta = delta_blob, True
                    rec = prev_rec + delta_rec
                    n_delta += 1
                else:
                    chosen, is_delta, rec = direct_blob, False, direct_rec
            parts.append((is_delta, chosen))
            prev_rec = rec  # decoder-exact state, no extra decode needed
        elog.info("DeltaCompressor: %d/%d slices used delta coding",
                  n_delta, nlev)
        head = struct.pack("<4sI", _MAGIC, nlev)
        body = b"".join(
            struct.pack("<BQ", int(d), len(b)) + b for d, b in parts)
        return head + body

    def decompress(self, blob: bytes) -> np.ndarray:
        magic, nlev = struct.unpack_from("<4sI", blob, 0)
        if magic != _MAGIC:
            raise ValueError("not a DeltaCompressor blob")
        off = struct.calcsize("<4sI")
        out = []
        prev = None
        for _ in range(nlev):
            is_delta, blen = struct.unpack_from("<BQ", blob, off)
            off += struct.calcsize("<BQ")
            dec = self.direct.decompress(blob[off:off + blen])
            off += blen
            prev = (prev + dec) if is_delta else dec
            out.append(prev)
        return np.stack(out)
