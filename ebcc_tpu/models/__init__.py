"""Higher-level compressor families built on the core codec.

The reference's "model zoo" is its family of wrapper compressors
(/root/reference/ebcc_wrapper/): direct pointwise, delta-in-pressure,
delta-in-time, rate-optimised (golden-section), forecast-predictive and
video-baseline.  Each has a batched device equivalent here.
"""

from .delta import DeltaCompressor
from .direct import DirectCompressor
from .forecast import (HAVE_FLAX, make_forecast_fn, train_forecaster)
from .predictive import PredictiveCompressor, persistence_forecast
from .rate_opt import RateOptimizedCompressor
from .video import VideoArrayCompressor
from .video import available as video_available

__all__ = [
    "DirectCompressor",
    "DeltaCompressor",
    "PredictiveCompressor",
    "persistence_forecast",
    "train_forecaster",
    "make_forecast_fn",
    "HAVE_FLAX",
    "RateOptimizedCompressor",
    "VideoArrayCompressor",
    "video_available",
]
