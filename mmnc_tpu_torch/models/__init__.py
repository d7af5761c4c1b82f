"""Codec models of the port."""

from .codecs import (MultiTaskDisjointLatentCompressor,
                     MultiTaskMixedLatentCompressor,
                     MultiTaskSharedLatentCompressor, SingleTaskCompressor,
                     build_model)

__all__ = ["MultiTaskDisjointLatentCompressor",
           "MultiTaskMixedLatentCompressor",
           "MultiTaskSharedLatentCompressor", "SingleTaskCompressor",
           "build_model"]
