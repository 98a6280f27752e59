"""EBCC-TPU: an error-bounded climate compressor for accelerators.

A from-scratch JAX/XLA re-design of the capabilities of jia-yli/EBCC
(an HDF5-filter error-bounded compressor for 2-D geophysical fields): a
JPEG2000-style wavelet base layer plus an embedded bitplane-coded residual
layer, with max-error / relative-error / pointwise error-bound enforcement,
batched over frames and sharded over device meshes.
"""

from .api import compress, compress_multi_q, decompress
from .codec.config import EBCCConfig, ResidualMode
from .models import (DeltaCompressor, DirectCompressor, PredictiveCompressor,
                     RateOptimizedCompressor)

__version__ = "0.1.0"

__all__ = ["compress", "compress_multi_q", "decompress", "EBCCConfig",
           "ResidualMode", "DirectCompressor", "DeltaCompressor",
           "PredictiveCompressor", "RateOptimizedCompressor", "__version__"]
