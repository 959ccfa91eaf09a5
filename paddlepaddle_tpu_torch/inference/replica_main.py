"""Replica server: one serving engine per OS process.

``python -m paddlepaddle_tpu_torch.inference.replica_main --bundle PATH
--socket SOCK`` (or ``--port N`` for loopback TCP) boots a
:class:`~.serving.ServingEngine` over the port's Llama in a fresh process,
then serves submit/health/drain/restart over the C-API frame protocol
(:mod:`~.c_api_server`) for a :class:`~.remote_replica.RemoteReplicaClient`.

The port's counterpart of ``paddlepaddle_tpu/inference/replica_main.py``:
the same presets, ``--model-json`` overrides, ``REPLICA_READY`` line and
exit codes; the model is the port's ``LlamaForCausalLM``, its weights drawn
from seed 0 through the port's RNG. It serves on the card unless
``--device cpu`` is given. Its ``_OP_HEALTH`` answer adds a ``kernels``
block: the paged-attention kernel's launches in this process and the
``nvcc`` runs it started (0 after a respawn: the libraries are on disk or
come with ``--bundle``), and under a plan of several ranks the counters
of every rank (``ranks``). ``--engine-json '{"mesh": "mp2"}'`` serves a
tensor-parallel replica: this process is rank 0 and the engine starts its
worker ranks, which end with it (SIGKILL included).

Lifecycle contract (what :class:`~.remote_replica.ReplicaSupervisor`
builds on):

* stdout line ``REPLICA_READY {json}`` exactly once, after the engine is
  started (and warmed/bundle-armed) and the socket is listening — the
  JSON carries pid, socket/port, and the bundle status;
* ``--bundle`` is STRICT by default: a bundle that falls back to lazy
  builds exits 3 before serving (a deploy must never silently serve the
  slow path as the new version) — ``--allow-bundle-fallback`` restores
  the engine's forgiving production default;
* SIGTERM drains via the preemption hook (in-flight requests finish,
  queued ones shed typed) and exits 143 — the supervisor's graceful
  restart half; SIGKILL is the chaos half, no cooperation required.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

# mirror tools/coldstart_bench.py: the tiny preset is the test fleet's
# model, the small preset the CPU bench's
PRESETS = {
    "tiny": dict(vocab_size=128, hidden_size=64, intermediate_size=192,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=96),
    "small": dict(vocab_size=512, hidden_size=256, intermediate_size=768,
                  num_hidden_layers=4, num_attention_heads=8,
                  num_key_value_heads=4, max_position_embeddings=512),
}


def _build_model(preset: str, model_json: str | None, device):
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    kw = dict(PRESETS[preset])
    if model_json:
        kw.update(json.loads(model_json))
    kw.setdefault("dtype", "float32")
    pt.seed(0)
    return LlamaForCausalLM(LlamaConfig(**kw), device=device, seed=0)


def _health_with_kernels(eng):
    """``eng.health()`` plus the kernel counters, so a parent can see over
    the wire that the decode ran through the paged kernel: this process's
    (rank 0's) paged launches, int8 launches and ``nvcc`` runs and, for an
    engine over a plan of several ranks, under ``ranks`` the counters of
    every rank in rank order (gathered from the worker ranks; None for a
    rank that is gone)."""
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as _pa

    def health():
        snap = eng.health()
        fn = _pa.paged_attention
        kernels = {"paged_attention": fn.launches,
                   "paged_attention_int8": fn.int8_launches,
                   "nvcc_runs": _build.nvcc_runs}
        engine = eng._engine
        if engine is not None and engine.plan is not None \
                and engine.plan.n_devices > 1:
            kernels["ranks"] = engine._rank_counters()
        snap["kernels"] = kernels
        return snap

    return health


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddlepaddle_tpu_torch.inference.replica_main",
        description=__doc__.split("\n")[0])
    ap.add_argument("--bundle", default=None,
                    help="AOT serving bundle to arm the engine from "
                    "(strict: a fallback to lazy builds exits 3)")
    ap.add_argument("--allow-bundle-fallback", action="store_true",
                    help="serve even when the bundle did not load "
                    "(the engine's forgiving lazy-build fallback)")
    ap.add_argument("--socket", default=None,
                    help="Unix domain socket path to serve on")
    ap.add_argument("--port", type=int, default=None,
                    help="loopback TCP port (0 = ephemeral; the REPLICA_"
                    "READY line reports the resolved port)")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--model-json", default=None,
                    help="JSON dict of LlamaConfig overrides on the preset")
    ap.add_argument("--engine-json", default=None,
                    help="JSON dict of ServingEngine kwargs "
                    "(max_batch_size, decode_chunk, kv_page_size, ...)")
    ap.add_argument("--warmup", choices=["auto", "on", "off"],
                    default="auto",
                    help="auto: warm only when no bundle loaded (a loaded "
                    "bundle already has every program)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="start the Prometheus /metrics + /healthz "
                    "exporter on this port (0 = ephemeral)")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    help="SIGTERM drain bound (seconds)")
    ap.add_argument("--server-json", default=None,
                    help="JSON dict of CApiServer kwargs "
                    "(heartbeat_interval_s, write_timeout_s, "
                    "frame_timeout_s, send_buffer_bytes, result_cache "
                    "— the wire-hardening knobs)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card; cpu for "
                    "tests)")
    args = ap.parse_args(argv)
    if (args.socket is None) == (args.port is None):
        ap.error("exactly one of --socket / --port is required")

    t0 = time.perf_counter()
    from paddlepaddle_tpu_torch.device import resolve_device
    from paddlepaddle_tpu_torch.inference.c_api_server import CApiServer
    from paddlepaddle_tpu_torch.inference.serving import ServingEngine

    device = resolve_device(args.device)
    model = _build_model(args.preset, args.model_json, device)
    t_model = time.perf_counter()
    eng_kw = json.loads(args.engine_json) if args.engine_json else {}
    eng_kw.setdefault("max_batch_size", 2)
    eng_kw.setdefault("decode_chunk", 4)
    eng_kw.setdefault("kv_page_size", 16)
    eng = ServingEngine(model, bundle=args.bundle,
                        drain_on_sigterm=True,
                        drain_timeout_s=args.drain_timeout, device=device,
                        **eng_kw)
    bundle_info = dict(getattr(eng._engine, "_bundle_info", None) or {})
    if args.bundle and not bundle_info.get("loaded") \
            and not args.allow_bundle_fallback:
        sys.stderr.write(
            f"[replica_main] bundle did not load ({bundle_info}); "
            "refusing to serve the lazy path as this version "
            "(--allow-bundle-fallback to override)\n")
        return 3
    eng.start()
    if args.warmup == "on" or (args.warmup == "auto" and args.bundle
                               and not bundle_info.get("loaded")):
        eng.warmup()

    exporter_port = None
    if args.metrics_port is not None:
        from paddlepaddle_tpu_torch.observability import exporter

        exp = exporter.start(port=args.metrics_port)
        exporter_port = getattr(exp, "port", args.metrics_port)

    srv_kw = json.loads(args.server_json) if args.server_json else {}
    srv = CApiServer(None, socket_path=args.socket, port=args.port,
                     engine=eng, health_fn=_health_with_kernels(eng),
                     **srv_kw)
    srv.start()
    ready = {"pid": os.getpid(), "socket": args.socket, "port": srv.port,
             "metrics_port": exporter_port,
             "bundle": {"path": args.bundle,
                        "loaded": bool(bundle_info.get("loaded"))},
             # the coldstart bench's comparable window: imports + model
             # build (checkpoint-shaped, identical in-process) vs engine
             # bring-up (ctor + bundle load + warmup — what a restart
             # strategy actually changes)
             "t_model_build_s": round(t_model - t0, 3),
             "t_engine_ready_s": round(time.perf_counter() - t_model, 3)}
    print("REPLICA_READY " + json.dumps(ready), flush=True)
    # serve until SIGTERM: the preemption hook (installed by
    # drain_on_sigterm=True at engine start) drains and exits 143
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        eng.drain(args.drain_timeout, reason="sigint")
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
