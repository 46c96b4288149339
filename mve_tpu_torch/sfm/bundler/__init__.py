"""Incremental SfM pipeline components (reference: libs/sfm/bundler_*):
per-view features, pairwise matching and the prebundle file, tracks,
intrinsics, the initial pair and the incremental loop."""

from .common import (
    Viewport, Track, FeatureReference, TwoViewMatching,
    save_prebundle, load_prebundle, undistort_feature)
from .features import Features, FeaturesOptions
from .matching import Matching, MatchingOptions as BundlerMatchingOptions
from .matching_batched import BatchedMatching
from .tracks import Tracks, TracksOptions
from .init_pair import InitialPair, InitialPairOptions
from .intrinsics import Intrinsics, IntrinsicsOptions
from .incremental import Incremental, IncrementalOptions

__all__ = [
    "Viewport", "Track", "FeatureReference", "TwoViewMatching",
    "save_prebundle", "load_prebundle", "undistort_feature",
    "Features", "FeaturesOptions",
    "Matching", "BundlerMatchingOptions", "BatchedMatching",
    "Tracks", "TracksOptions",
    "InitialPair", "InitialPairOptions",
    "Intrinsics", "IntrinsicsOptions",
    "Incremental", "IncrementalOptions",
]
