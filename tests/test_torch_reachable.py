"""A reference program moved to the port finds every name at the
reference's import path (ROADMAP queue C, C14).

For each module of ``paddlepaddle_tpu`` whose counterpart exists in
``paddlepaddle_tpu_torch`` under the same dotted name (the package root
included), every public class or function the reference module exposes
whose home module's port counterpart defines the same name must be
reachable from the port module under that name. A name the port has not
ported yet (its home module lacks it) is not asked for. The allow-list
holds incidental imports that are not API, one comment each.
"""

import importlib
import inspect
import pkgutil

import paddlepaddle_tpu_torch

PORT, REF = "paddlepaddle_tpu_torch", "paddlepaddle_tpu"

ALLOWED = {
    # the container a model file builds its layer stack from, imported for
    # its own use; the reference's public path is nn.LayerList
    "paddlepaddle_tpu_torch.models.bert.LayerList",
    "paddlepaddle_tpu_torch.models.llama.LayerList",
    "paddlepaddle_tpu_torch.models.moe.LayerList",
    # the reference's MoE model imports the Llama model for its loss helper
    "paddlepaddle_tpu_torch.models.moe.LlamaForCausalLM",
    # the encoder imports its default activation layer
    "paddlepaddle_tpu_torch.nn.transformer.ReLU",
    # the kernel modules read their Pallas flags through flag_value; the
    # port's kernels read no flag
    "paddlepaddle_tpu_torch.ops.kernels.flash_attention.flag_value",
    "paddlepaddle_tpu_torch.ops.kernels.gather_gemm.flag_value",
    "paddlepaddle_tpu_torch.ops.kernels.paged_attention.flag_value",
}


def _module_names():
    yield PORT
    for info in pkgutil.walk_packages(paddlepaddle_tpu_torch.__path__,
                                      PORT + "."):
        yield info.name


def _port_home(obj):
    """The port module that would define ``obj``'s counterpart, or None."""
    home = getattr(obj, "__module__", None) or ""
    if home != REF and not home.startswith(REF + "."):
        return None
    try:
        return importlib.import_module(PORT + home[len(REF):])
    except ImportError:
        return None


def test_reference_names_reachable_at_reference_paths():
    missing, checked, allowed_seen = [], 0, set()
    for name in _module_names():
        port_mod = importlib.import_module(name)
        try:
            ref_mod = importlib.import_module(REF + name[len(PORT):])
        except ImportError:
            continue
        for attr, obj in vars(ref_mod).items():
            if attr.startswith("_") or not (inspect.isclass(obj)
                                            or inspect.isfunction(obj)):
                continue
            home = _port_home(obj)
            if home is None or attr not in vars(home):
                continue
            checked += 1
            qual = f"{name}.{attr}"
            if hasattr(port_mod, attr):
                continue
            if qual in ALLOWED:
                allowed_seen.add(qual)
                continue
            missing.append(f"{qual} (defined in {home.__name__})")
    assert not missing, "\n".join(missing)
    assert checked > 500
    # an entry that became reachable must leave the list
    assert allowed_seen == ALLOWED


def test_names_of_c14_resolve():
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch import (core, incubate, inference, models,
                                        nn, resilience)

    for mod, names in (
            (pt, ("seed", "get_rng_state", "set_rng_state", "set_flags",
                  "get_flags")),
            (inference, ("ServingEngine", "CompilePlan", "ServingRouter",
                         "ReplicaClient", "FleetController", "FleetPolicy",
                         "RemoteReplicaClient", "ReplicaSupervisor",
                         "ProcessReplicaFactory", "DeployError",
                         "FleetUnavailableError")),
            (models, ("LlamaModel",)),
            (nn, ("GradientClipByGlobalNorm", "GradientClipByNorm",
                  "GradientClipByValue")),
            (nn.functional, ("flash_attn_qkvpacked",
                             "flash_attn_varlen_qkvpacked")),
            (incubate.nn.functional, ("swiglu",)),
            (resilience, ("install_preemption_handler", "chaos_point",
                          "NetChaosProxy", "RetryPolicy")),
            (core.flags, ("get_flags",))):
        for n in names:
            assert hasattr(mod, n), f"{mod.__name__}.{n}"


def test_get_flags_matches_reference():
    from paddlepaddle_tpu.core import flags as jflags
    from paddlepaddle_tpu_torch.core import flags as tflags

    for f in (tflags, jflags):
        f.set_flags({"serving_max_queue": 7})
    try:
        for arg in ("serving_max_queue", ["FLAGS_serving_max_queue"]):
            assert tflags.get_flags(arg) == jflags.get_flags(arg)
        assert tflags.get_flags("serving_max_queue") == {
            "serving_max_queue": 7}
        for f in (tflags, jflags):
            try:
                f.get_flags("no_such_flag_anywhere")
            except ValueError:
                pass
            else:
                raise AssertionError(f"{f.__name__}: unknown flag answered")
    finally:
        for f in (tflags, jflags):
            f.set_flags({"serving_max_queue": 0})
