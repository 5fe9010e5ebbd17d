"""Simple-repr serialization.

Turns objects into nested dicts of primitives (and back) so that every
message, problem object and result can be round-tripped through JSON/YAML.
This is the wire format for the host-side control plane, exactly the role
``pydcop/utils/simple_repr.py`` plays in the reference; the design here is
independent (introspection of ``__init__`` parameters against attributes,
with a ``_repr_excluded``/mapping override hook).

On the TPU compute path nothing is serialized per-message — device arrays
never go through this layer — so this module is deliberately plain Python.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any

# Dict key carrying the qualified class name in a serialized object.
_CLASS_KEY = "__qualified_name__"
_MODULE_KEY = "__module__"


class SimpleReprException(Exception):
    pass


def _is_primitive(o: Any) -> bool:
    return o is None or isinstance(o, (bool, int, float, str))


class SimpleRepr:
    """Mixin providing ``_simple_repr()`` / ``_from_repr()``.

    The default implementation introspects the constructor: for each
    parameter ``p`` of ``__init__``, the instance must expose an attribute
    ``p`` or ``_p`` whose value is itself simple-representable.  Subclasses
    with non-trivial constructors can override ``_simple_repr`` /
    ``_from_repr`` or set ``_repr_mapping`` ({param_name: attr_name}).
    """

    _repr_mapping: dict = {}

    def _simple_repr(self) -> dict:
        r: dict = {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
        }
        sig = inspect.signature(type(self).__init__)
        for name, param in sig.parameters.items():
            if name == "self":
                continue
            if param.kind in (
                inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD,
            ):
                continue
            attr = self._repr_mapping.get(name, name)
            if hasattr(self, attr):
                val = getattr(self, attr)
            elif hasattr(self, "_" + attr):
                val = getattr(self, "_" + attr)
            else:
                raise SimpleReprException(
                    f"Cannot build simple repr for {type(self).__name__}: "
                    f"no attribute for constructor parameter {name!r}"
                )
            r[name] = simple_repr(val)
        return r

    @classmethod
    def _from_repr(cls, r: dict):
        args = {
            k: from_repr(v)
            for k, v in r.items()
            if k not in (_CLASS_KEY, _MODULE_KEY)
        }
        return cls(**args)


def simple_repr(o: Any) -> Any:
    """Return a nested structure of primitives representing ``o``."""
    if _is_primitive(o):
        return o
    if isinstance(o, (list, tuple, set, frozenset)):
        kind = {
            list: "list",
            tuple: "tuple",
            set: "set",
            frozenset: "frozenset",
        }[type(o)]
        items = [simple_repr(i) for i in o]
        if kind == "list":
            return items
        return {_CLASS_KEY: kind, "items": items}
    if isinstance(o, dict):
        # JSON only supports string keys; keep primitives as-is and tag.
        return {
            _CLASS_KEY: "dict",
            "items": [[simple_repr(k), simple_repr(v)] for k, v in o.items()],
        }
    if isinstance(o, SimpleRepr):
        return o._simple_repr()
    # numpy scalars and arrays → python lists (host control plane only)
    if hasattr(o, "tolist"):
        return {_CLASS_KEY: "array", "items": o.tolist()}
    raise SimpleReprException(
        f"Cannot build a simple repr for object of type {type(o)}: {o!r}"
    )


def from_repr(r: Any) -> Any:
    """Rebuild an object from its simple repr."""
    if _is_primitive(r):
        return r
    if isinstance(r, list):
        return [from_repr(i) for i in r]
    if isinstance(r, dict):
        qn = r.get(_CLASS_KEY)
        if qn is None:
            # plain mapping (e.g. parsed YAML) — rebuild values
            return {k: from_repr(v) for k, v in r.items()}
        if qn == "dict":
            return {from_repr(k): from_repr(v) for k, v in r["items"]}
        if qn in ("tuple", "set", "frozenset"):
            ctor = {"tuple": tuple, "set": set, "frozenset": frozenset}[qn]
            return ctor(from_repr(i) for i in r["items"])
        if qn == "array":
            import numpy as np

            return np.asarray(r["items"])
        module = importlib.import_module(r[_MODULE_KEY])
        cls = module
        for part in qn.split("."):
            cls = getattr(cls, part)
        if not (inspect.isclass(cls) and issubclass(cls, SimpleRepr)):
            raise SimpleReprException(
                f"{qn} in {r[_MODULE_KEY]} is not a SimpleRepr class"
            )
        return cls._from_repr(r)
    raise SimpleReprException(f"Cannot rebuild object from repr {r!r}")
