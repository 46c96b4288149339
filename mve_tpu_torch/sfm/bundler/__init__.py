"""Bundler front end: per-view features, pairwise matching and the
prebundle file (reference: libs/sfm/bundler_*)."""

from .common import Viewport, TwoViewMatching, save_prebundle, load_prebundle
from .features import Features, FeaturesOptions
from .matching import Matching, MatchingOptions as BundlerMatchingOptions
from .matching_batched import BatchedMatching

__all__ = [
    "Viewport", "TwoViewMatching", "save_prebundle", "load_prebundle",
    "Features", "FeaturesOptions",
    "Matching", "BundlerMatchingOptions", "BatchedMatching",
]
