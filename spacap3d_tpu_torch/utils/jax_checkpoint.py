"""Reads the JAX package's checkpoints without JAX or optax.

The JAX package writes a checkpoint as a pickle of host numpy trees
(``spacap3d_tpu/utils/checkpoint.py``): ``params``, ``state`` (batch-norm
running statistics), ``opt_state`` (optax's state records), ``step``,
``iter``, ``epoch``, ``best`` and ``config``. Its ENet weights may also be
a pickle of ``jax.Array`` leaves. ``JaxUnpickler`` reads both:

  * optax's and chex's classes become ``JaxRecord``s, tuples of the
    pickled fields that keep the class's name (a namedtuple state pickles
    its field values in order, not their names);
  * a pickled ``jax.Array`` (``jax._src.array._reconstruct_array``) becomes
    the numpy array it carries;
  * numpy's array and scalar reconstructors and a few builtin containers
    load as usual; every other global is refused.

A torch checkpoint is a zip archive (``torch.save``); ``is_jax_checkpoint``
tells the two apart.
"""
from __future__ import annotations

import pickle
import zipfile
from typing import Any, Dict, List

import numpy as np

_NUMPY = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
}
_BUILTINS = {("builtins", n) for n in ("set", "frozenset", "slice", "complex", "range",
                                       "bytearray")} | {("collections", "OrderedDict")}
_RECORD_ROOTS = ("optax", "chex")


class JaxRecord(tuple):
    """An optax or chex object as pickled: its fields, in order, and its
    class's qualified name (``cls``, e.g. ``optax._src.transform.ScaleByAdamState``)."""

    cls = ""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __setstate__(self, state):
        self.__dict__["state"] = state

    @property
    def name(self) -> str:
        return self.cls.rsplit(".", 1)[-1]

    def __repr__(self):
        return f"{self.name}{tuple.__repr__(self)}"


_record_classes: Dict[str, type] = {}


def _record_class(module: str, name: str) -> type:
    key = f"{module}.{name}"
    if key not in _record_classes:
        _record_classes[key] = type(name, (JaxRecord,), {"cls": key})
    return _record_classes[key]


def _array_from_jax(fun, args, arr_state, aval_state):
    """What ``jax._src.array._reconstruct_array`` does, without the device:
    the numpy array a pickled ``jax.Array`` carries."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class JaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY or (module, name) in _BUILTINS or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        if module == "jax._src.array" and name == "_reconstruct_array":
            return _array_from_jax
        if module.split(".")[0] in _RECORD_ROOTS:
            return _record_class(module, name)
        raise pickle.UnpicklingError(f"refusing {module}.{name}: a JAX checkpoint holds "
                                     "numpy arrays, builtins and optax or chex state only")


def load_jax_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return JaxUnpickler(f).load()


def is_jax_checkpoint(path: str) -> bool:
    """True for a pickle (the JAX package's format), False for a
    ``torch.save`` zip archive."""
    return not zipfile.is_zipfile(path)


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    payload = load_jax_pickle(path)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a JAX-package checkpoint: no 'params'")
    return payload


def records(tree: Any, name: str) -> List[JaxRecord]:
    """Every ``JaxRecord`` named ``name`` in ``tree``, in tree order."""
    found = []
    if isinstance(tree, JaxRecord) and tree.name == name:
        found.append(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            found += records(tree[k], name)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found += records(v, name)
    return found


def scalar(x) -> Any:
    """A 0-d numpy array or numpy scalar as the Python int or float."""
    return np.asarray(x).item()
