"""Codec models of the port."""

from .codecs import SingleTaskCompressor, build_model

__all__ = ["SingleTaskCompressor", "build_model"]
