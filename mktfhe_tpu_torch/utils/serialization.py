"""Key and scheme serialization.

Port of mktfhe_tpu/utils/serialization.py.  Every key object of the port
(party keys, aggregated schemes, the engines' phase-1 keys, LWE keys and
ciphertexts) is a flat dataclass or NamedTuple of tensors, so a checkpoint
is a plain .npz archive: a manifest of the class (`__module__`,
`__qualname__`) and one array per field, in the JAX package's layout.
Torus values and residues are stored unsigned (uint32 / uint64), as the JAX
package stores them, not as the signed carriers the port computes on;
int8 key-switch tables as they are.

Files the JAX package wrote load into the port: the manifest's
`mktfhe_tpu.` module prefix names the port's module of the same path (by
string: the JAX package is never imported), the Shoup companions
(`*_shoup`), which the port never stores, are dropped, and unsigned arrays
are viewed as the port's carriers by `bridge.py`'s own conversion (u32 ->
int32, u64 -> int64).  The other way round is not offered: the JAX package's
`load` rebuilds its own classes, whose Shoup fields a file of the port
does not hold.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from ..bridge import from_numpy, to_numpy

_JAX_PACKAGE = "mktfhe_tpu."
_PORT_PACKAGE = "mktfhe_tpu_torch."
_MANIFEST = ("__module__", "__qualname__")


def _fields(obj_or_cls) -> list[str]:
    if dataclasses.is_dataclass(obj_or_cls):
        return [f.name for f in dataclasses.fields(obj_or_cls)]
    if hasattr(obj_or_cls, "_fields"):  # NamedTuple
        return list(obj_or_cls._fields)
    raise TypeError(f"not a serializable key object: {obj_or_cls}")


def save(path: str, obj) -> None:
    """Save a dataclass / NamedTuple of tensors to an .npz archive, int32 /
    int64 carriers as uint32 / uint64."""
    arrays = {name: to_numpy(getattr(obj, name)) for name in _fields(obj)}
    cls = type(obj)
    np.savez(path, __module__=np.array(cls.__module__), __qualname__=np.array(cls.__qualname__), **arrays)


def _port_class(module: str, qualname: str):
    if module.startswith(_JAX_PACKAGE):
        module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
    if not module.startswith(_PORT_PACKAGE):
        raise ValueError(f"{module}.{qualname} is no class of mktfhe_tpu or mktfhe_tpu_torch")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    return cls


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false; pass device='cpu'")
    return device


def load(path: str, device=None):
    """Load an object saved by `save` (or by the JAX package's `save`) onto
    `device` (default: cuda, which raises without a card), as the port's
    class of the manifest's name."""
    device = _device(device)
    with np.load(path, allow_pickle=False) as z:
        cls = _port_class(str(z["__module__"]), str(z["__qualname__"]))
        names = _fields(cls)
        stored = [k for k in z.files if k not in _MANIFEST]
        extra = [k for k in stored if k not in names and not k.endswith("_shoup")]
        missing = [k for k in names if k not in stored]
        if extra or missing:
            raise ValueError(f"{path} does not hold a {cls.__qualname__}: fields {missing} missing, "
                             f"{extra} unknown")
        kwargs = {name: from_numpy(z[name], device) for name in names}
    return cls(**kwargs)
