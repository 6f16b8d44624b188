"""Utilities: serialization, noise measurement, profiling (port of
mktfhe_tpu/utils/)."""

from .serialization import load, save

__all__ = ["load", "save"]
