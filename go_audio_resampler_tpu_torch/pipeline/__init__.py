"""Inter-stage plumbing (host side)."""

from .buffer import SampleFIFO

__all__ = ["SampleFIFO"]
