"""Every public function and class of the port keeps the reference's
positional parameters (ROADMAP queue C: C4, C5, C8, C10, C11 and C12 were
each a reference parameter dropped from the middle of a positional order,
found by hand).

For each module of ``paddlepaddle_tpu_torch`` whose counterpart exists in
``paddlepaddle_tpu`` under the same dotted name, and each public function
or class the port module defines that the reference module also has, the
positional-parameter names of the function (or of the class's
``__init__`` / ``forward`` / ``__call__`` / ``step`` / ``submit`` /
``serve`` / ``generate``, where both packages define the method
themselves) must start with the reference's list: the port may add
parameters only after the reference's, as ``device`` / ``seed`` are.
Keyword-only parameters are not compared. The exceptions are the
allow-list below, each naming its ROADMAP entry.
"""

import importlib
import inspect
import pkgutil

import paddlepaddle_tpu_torch

PORT, REF = "paddlepaddle_tpu_torch", "paddlepaddle_tpu"
METHODS = ("__init__", "forward", "__call__", "step", "submit", "serve",
           "generate")

ALLOWED = {
    # split gate/up banks (x, slot_entry, wg, wu, wd) against the
    # reference's fused (x, slot_entry, wgu, wd): ROADMAP "Recorded
    # deviations"; a reference-order call raises TypeError, never binds
    "paddlepaddle_tpu_torch.ops.kernels.gather_gemm.gather_gemm_ffn",
}


def _positional(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name != "self"]


def _own_method(cls, name, package):
    """``cls.name`` when a class of ``package`` defines it, else None."""
    for klass in cls.__mro__:
        if name in klass.__dict__:
            if klass.__module__.split(".")[0] != package:
                return None
            return klass.__dict__[name]
    return None


def _pairs(port_mod, ref_mod):
    for name, obj in vars(port_mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != port_mod.__name__:
            continue
        ref = getattr(ref_mod, name, None)
        if ref is None:
            continue
        qual = f"{port_mod.__name__}.{name}"
        if inspect.isclass(obj) and inspect.isclass(ref):
            for meth in METHODS:
                a = _own_method(obj, meth, PORT)
                b = _own_method(ref, meth, REF)
                if a is not None and b is not None:
                    yield f"{qual}.{meth}", a, b
        elif inspect.isfunction(obj) and callable(ref):
            yield qual, obj, ref


def test_port_keeps_reference_positional_parameters():
    mismatches, compared, allowed_seen = [], 0, set()
    for info in pkgutil.walk_packages(paddlepaddle_tpu_torch.__path__,
                                      PORT + "."):
        port_mod = importlib.import_module(info.name)
        try:
            ref_mod = importlib.import_module(REF + info.name[len(PORT):])
        except ImportError:
            continue
        for qual, a, b in _pairs(port_mod, ref_mod):
            pa, pb = _positional(a), _positional(b)
            if pa is None or pb is None:
                continue
            compared += 1
            if pa[:len(pb)] == pb:
                continue
            if qual in ALLOWED:
                allowed_seen.add(qual)
                continue
            mismatches.append(f"{qual}: port {pa}, reference {pb}")
    assert not mismatches, "\n".join(mismatches)
    assert compared > 300
    # an allow-list entry that no longer differs must leave the list
    assert allowed_seen == ALLOWED
