"""Functions sent by value to the worker ranks of a single-process plan
(the port has no counterpart in the reference, whose one process never
sends a function anywhere).

A ``spawn`` worker receives its arguments pickled, and ``pickle`` sends a
function by reference (module and name), so a lambda, a nested function or
a function of the caller's ``__main__`` fails there or on the other side.
:func:`ship` wraps such a function so that it pickles by value: its code
object (``marshal``, both sides run the same interpreter), name, defaults,
keyword defaults, the contents of its closure cells and the globals its
code names. Each of those values is sent as ``pickle`` sends it, except
that a module goes by its name (imported again on the other side) and such
a function is shipped by value in turn; a function that an importable
module defines at its top level goes by name. Whatever cannot be sent
raises :class:`ShipError` here, in the caller's process, naming it: never
later in a worker, and never as a hang.
"""

from __future__ import annotations

import builtins
import importlib
import marshal
import pickle
import sys
import types
from typing import Dict, Optional, Set


class ShipError(TypeError):
    """A function (or a value it needs) that cannot be sent to a worker."""


class _EmptyCell:
    """A closure cell not yet assigned."""


class _Module:
    """A module, sent by name."""

    def __init__(self, name: str):
        self.name = name

    def __reduce__(self):
        return (importlib.import_module, (self.name,))


class ShippedFunction:
    """``fn`` in a form that pickles by value; calling it calls ``fn``. On
    the other side of a pickle it is ``fn`` rebuilt, a plain function."""

    def __init__(self, fn: types.FunctionType, what: str,
                 _busy: Optional[Set[int]] = None):
        self.__wrapped__ = fn
        self.payload = _payload(fn, what, _busy if _busy is not None
                                else set())

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    def __reduce__(self):
        return (_rebuild, (self.payload,))


def _names(code: types.CodeType) -> Set[str]:
    """The global names ``code`` and the code objects nested in it read."""
    out = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            out |= _names(c)
    return out


def _by_name(fn: types.FunctionType) -> bool:
    """Whether ``pickle`` can send ``fn`` by reference: an importable
    module (not ``__main__``) defines it at its top level under its name."""
    mod = sys.modules.get(fn.__module__)
    if mod is None or fn.__module__ == "__main__" or "<" in fn.__qualname__:
        return False
    obj = mod
    for part in fn.__qualname__.split("."):
        obj = getattr(obj, part, None)
    return obj is fn


def _value(v, what: str, busy: Set[int]):
    if isinstance(v, types.ModuleType):
        return _Module(v.__name__)
    if isinstance(v, types.FunctionType) and not _by_name(v):
        return ShippedFunction(v, what, busy)
    try:
        pickle.dumps(v)
    except Exception as e:  # noqa: BLE001 — any pickling fault is named
        raise ShipError(f"{what} holds a {type(v).__name__} that cannot be "
                        f"sent to a worker rank: {e}") from e
    return v


def _payload(fn: types.FunctionType, what: str,
             busy: Set[int]) -> Dict[str, object]:
    if id(fn) in busy:
        raise ShipError(f"{what}: {fn.__qualname__} refers to itself; "
                        "define it at the top level of an importable module "
                        "so it is sent by name")
    busy.add(id(fn))
    try:
        label = f"{what} ({fn.__qualname__})"
        glob = {n: _value(fn.__globals__[n], f"{label}, global {n!r}", busy)
                for n in sorted(_names(fn.__code__))
                if n in fn.__globals__}
        cells = []
        for name, cell in zip(fn.__code__.co_freevars,
                              fn.__closure__ or ()):
            try:
                content = cell.cell_contents
            except ValueError:
                cells.append(_EmptyCell())
                continue
            cells.append(_value(content, f"{label}, closure {name!r}",
                                busy))
        return {
            "code": marshal.dumps(fn.__code__),
            "name": fn.__name__,
            "qualname": fn.__qualname__,
            "module": fn.__module__,
            "globals": glob,
            "defaults": _value(fn.__defaults__, f"{label}, defaults", busy),
            "kwdefaults": _value(fn.__kwdefaults__,
                                 f"{label}, keyword defaults", busy),
            "closure": cells,
        }
    finally:
        busy.discard(id(fn))


def _rebuild(payload: Dict[str, object]) -> types.FunctionType:
    glob = {"__builtins__": builtins, "__name__": payload["module"]}
    glob.update(payload["globals"])
    closure = tuple(types.CellType() if isinstance(c, _EmptyCell)
                    else types.CellType(c)
                    for c in payload["closure"]) or None
    fn = types.FunctionType(marshal.loads(payload["code"]), glob,
                            payload["name"], payload["defaults"], closure)
    fn.__kwdefaults__ = payload["kwdefaults"]
    fn.__qualname__ = payload["qualname"]
    fn.__module__ = payload["module"]
    return fn


def ship(obj, what: str = "function"):
    """``obj`` in a form a worker rank receives: a function that cannot go
    by name (a lambda, a nested function, one of ``__main__``) shipped by
    value, any other object as it is once ``pickle`` has shown it can send
    it. Raises :class:`ShipError`, naming ``what`` and the part at fault,
    when it cannot be sent."""
    if isinstance(obj, types.FunctionType) and not _by_name(obj):
        out = ShippedFunction(obj, what)
    else:
        out = obj
    try:
        pickle.dumps(out)
    except ShipError:
        raise
    except Exception as e:  # noqa: BLE001 — any pickling fault is named
        raise ShipError(f"{what} ({type(obj).__name__}) cannot be sent to a "
                        f"worker rank: {e}") from e
    return out
