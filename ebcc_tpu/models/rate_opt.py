"""Rate optimisation: best total compression ratio at a fixed bound.

Equivalent of stack B's ``golden_section_search_best_compression``
(/root/reference/ebcc_wrapper/image_compression.py:499-567).  The reference
golden-section-searches the JP2K cratio, where *every probe is a full
JP2K encode+decode of the whole stack* — the dominant cost of the whole
system (SURVEY.md §3.4).

This codec removes most of that search by construction: its base layer is
an *embedded* bitstream, so the minimal feasible truncation at the bound is
found in one batched device call.  The one remaining degree of freedom is the
base-layer feasibility quantile ``q`` (how much error the base layer may
leave for the residual layer, j2k_codec.h:475-480): small q = heavy base /
light residual, large q = light base / heavy residual.  ``q`` is a traced
scalar, so evaluating a candidate costs one device dispatch with **no
recompilation** — the candidate sweep replaces the reference's sequential
golden-section probes.
"""

from __future__ import annotations

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from ..utils import logging as elog

DEFAULT_CANDIDATES = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


class RateOptimizedCompressor:
    """Compressor that sweeps the base-quantile knob for the best CR.

    ``compress`` returns ``(blob, info)``; ``info`` carries per-candidate
    sizes/CRs (the analogue of stack B's rich ``info`` dicts,
    image_compression.py:140-274, consumed by
    scripts/scan_cratio/scan_cratio_single_level.py:56-90).
    """

    def __init__(self, config: EBCCConfig | None = None,
                 candidates=DEFAULT_CANDIDATES):
        self.config = config or EBCCConfig(mode=ResidualMode.MAX_ERROR)
        if self.config.mode not in (ResidualMode.MAX_ERROR,
                                    ResidualMode.RELATIVE_ERROR,
                                    ResidualMode.POINTWISE_MAX_ERROR):
            raise ValueError("rate optimisation needs an error-bounded mode")
        self.candidates = tuple(float(c) for c in candidates)

    def compress(self, data, error_bound=None):
        data = np.asarray(data, np.float32)
        # ONE device dispatch per batch evaluates every candidate: the
        # base transform/analysis/scan and the packed base arena are
        # shared, each candidate adds only its truncation choice and
        # residual layer (api.compress_multi_q) — vs the reference's one
        # full re-compression per golden-section probe
        blobs = api.compress_multi_q(data, self.candidates, self.config,
                                     error_bound=error_bound)
        sizes = {q: len(b) for q, b in zip(self.candidates, blobs)}
        best_q, best_blob = min(zip(self.candidates, blobs),
                                key=lambda qb: len(qb[1]))
        info = {
            "best_quantile": best_q,
            "candidate_sizes": sizes,
            "candidate_crs": {q: data.nbytes / s for q, s in sizes.items()},
            "cr": data.nbytes / len(best_blob),
        }
        elog.info("RateOptimizedCompressor: best q=%g CR=%.1fx",
                  best_q, info["cr"])
        return best_blob, info

    def decompress(self, blob: bytes) -> np.ndarray:
        return api.decompress(blob, self.config)
