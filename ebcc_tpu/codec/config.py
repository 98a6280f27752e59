"""Codec configuration and environment-variable handling.

Mirrors the reference's config surface: ``codec_config_t``
(/root/reference/src/j2k_codec.h:188-196), residual mode enum (:168-175) and
the env vars read by ``encode_climate_variable`` (:471-487).
"""

from __future__ import annotations

import dataclasses
import enum
import os


# hard ceiling on DWT levels, uniform across every implementation: the
# native encoder clamps to it and the hardened decoders (native plugin,
# runtime/cpu_decoder.py) reject streams beyond it, so the JAX path must
# never emit deeper transforms either.  8 levels cover frames up to
# 512-pixel minimum dimension at full depth; deeper buys nothing (the
# codec defaults to 5).
MAX_LEVELS = 8


class ResidualMode(enum.IntEnum):
    """Residual compression modes (j2k_codec.h:168-175)."""

    NONE = 0
    SPARSIFICATION_FACTOR = 1
    MAX_ERROR = 2
    RELATIVE_ERROR = 3
    QUANTILE = 4  # deprecated in the reference (asserts, j2k_codec.h:554)
    POINTWISE_MAX_ERROR = 5


# canonical mode-name vocabulary (shared by the CLI and the HDF5 wrapper)
MODE_NAMES = {
    "none": ResidualMode.NONE,
    "sparsification_factor": ResidualMode.SPARSIFICATION_FACTOR,
    "max_error": ResidualMode.MAX_ERROR,
    "relative_error": ResidualMode.RELATIVE_ERROR,
    "pointwise_max_error": ResidualMode.POINTWISE_MAX_ERROR,
}


@dataclasses.dataclass(frozen=True)
class EBCCConfig:
    """User-facing codec configuration.

    Equivalent of the reference ``codec_config_t`` plus the device-side
    knobs.
    """

    mode: ResidualMode = ResidualMode.MAX_ERROR
    base_cr: float = 100.0          # target CR of the base layer (f32 bytes)
    error: float = 0.0              # max-error / relative-error target
    residual_cr: float = 10.0       # SPARSIFICATION_FACTOR only
    pointwise_max_error_ratio: float = 1.0  # POINTWISE only

    # codec internals (static; affect the bitstream format)
    base_levels: int = 5            # DWT levels of the base layer
    residual_levels: int = 3        # DWT levels of the residual layer
    nchunks: int = 8                # truncation chunks per bitplane pass
    # (8 stripes give ~2% better CR than 4 at equal bound via finer
    # truncation granularity; candidate evaluation is batched so the extra
    # fine-scan cost is negligible on device)
    base_nplanes: int = 22
    residual_nplanes: int = 14
    # capacity of the pure-JAX packer/unpacker word buffers; must cover the
    # WORST-CASE full stream (~ nplanes + sign + group overhead bits/px),
    # otherwise near-lossless truncations would silently drop tail bits on
    # the fallback path (the native coder sizes its arena from the actual
    # truncation and needs no cap)
    base_cap_bits_per_px: int = 36
    residual_cap_bits_per_px: int = 24
    # chunk-masked last-plane truncation (format v4): after the prefix
    # truncation search, greedily drop final-plane chunks the error bound
    # does not need (6-9% of the base stream on ERA5 fields,
    # scripts/stripe_adaptive_study.py).  Streams stay decodable by any v4
    # decoder; disable to emit pure-prefix streams only.
    use_chunk_mask: bool = True
    # chunk-mask search rule (format v4 semantics are unaffected — any
    # keep-mask is decodable; this selects WHICH mask the encoder picks):
    #   "greedy": sequential accept scan over chunks (J serial recon
    #     evals per selection — the reference-style exact greedy).
    #   "union": all J single-drop candidates evaluated in ONE batched
    #     pass, then their feasible union (or the best feasible single if
    #     the union violates the bound).  Collapses the mask stage's
    #     serial depth from J recon evals to 2.
    # Greedy is the default; union trades J times the memory traffic
    # per evaluation for a serial depth of 2.  Which is faster on the
    # current device has not been measured.
    # Both backends implement both rules bit-identically
    # (tests/test_cpu_encoder.py); changing the rule changes blobs.
    mask_search: str = "greedy"
    zstd_level: int = 19            # residual entropy stage (ref uses 22)
    max_batch: int = 8              # frames per device dispatch
    prefetch_batches: int = 2       # device batches in flight (pipelining)
    # decompression backend: "device" (jitted recon) or "cpu" (the native
    # standalone decoder, no device round trip); "auto" is the device.
    # The two backends agree to ~1e-3 in data units, not bitwise;
    # workflows that need a decoder-exact reconstruction (the
    # delta/predictive chains, the exact-value patch) must pin a
    # deterministic backend — DirectCompressor normalises "auto" to a
    # fixed choice at construction for this reason.
    decode_backend: str = "auto"
    # encoding backend: "device" or "cpu" (the native standalone encoder,
    # byte-identical containers on the CPU backend); "auto" is the device.
    encode_backend: str = "auto"

    def __post_init__(self):
        if self.mode == ResidualMode.QUANTILE:
            raise ValueError("QUANTILE mode is deprecated "
                             "(reference: j2k_codec.h:554-555)")
        if self.base_levels > MAX_LEVELS or self.residual_levels > MAX_LEVELS:
            raise ValueError(
                f"DWT levels are capped at {MAX_LEVELS} (format limit: "
                "decoders reject deeper streams)")
        if self.decode_backend not in ("auto", "cpu", "device"):
            raise ValueError(
                f"decode_backend must be 'auto', 'cpu' or 'device', "
                f"got {self.decode_backend!r}")
        if self.encode_backend not in ("auto", "cpu", "device"):
            raise ValueError(
                f"encode_backend must be 'auto', 'cpu' or 'device', "
                f"got {self.encode_backend!r}")


def base_error_quantile(default: float = 1e-6) -> float:
    """EBCC_INIT_BASE_ERROR_QUANTILE: allowed fraction of points whose base-
    layer error may exceed the target (j2k_codec.h:475-480).  0 disables the
    residual layer (base alone must satisfy the bound everywhere)."""
    v = os.environ.get("EBCC_INIT_BASE_ERROR_QUANTILE")
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def pure_fallback_disabled() -> bool:
    """EBCC_DISABLE_PURE_JP2_FALLBACK (j2k_codec.h:481-483)."""
    return os.environ.get("EBCC_DISABLE_PURE_JP2_FALLBACK") is not None


def pure_fallback_consistency_disabled() -> bool:
    """EBCC_DISABLE_PURE_JP2_FALLBACK_CONSISTENCY (j2k_codec.h:484-487).

    Accepted for config-surface parity.  In the reference this skips a
    re-encode that restarts the pure-JP2 search from the initial base CR
    (j2k_codec.h:668-678).  In this codec the pure fallback is evaluated on
    the same embedded bitstream as the main search, so the two are
    consistent by construction and the flag has no effect.
    """
    return os.environ.get(
        "EBCC_DISABLE_PURE_JP2_FALLBACK_CONSISTENCY") is not None
