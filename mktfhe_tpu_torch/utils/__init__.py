"""Utilities: serialization, noise measurement, profiling (port of
mktfhe_tpu/utils/)."""

__all__ = ["load", "save"]


def __getattr__(name: str):
    # imported when first asked for: the bootstraps import utils.profiling,
    # and serialization imports the bootstraps' modules (through bridge.py)
    if name in __all__:
        from . import serialization

        return getattr(serialization, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
