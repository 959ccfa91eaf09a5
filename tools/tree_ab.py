"""Time one ``chip_smoke.py`` phase in two checkouts on the same card, in
the order A, B, B, A, so that drift over the call falls on both sides.

    python3 tools/tree_ab.py --phase moe_train --a _archive/parent --b .

Each run is a fresh process started in its checkout (``cwd`` and
``sys.path`` are that tree's, so each imports its own package and builds
its own kernels at first use). It calls ``chip_smoke.phase_<name>(pt)``
and its JSON lines are kept. The script prints one line per run with the
phase's ``step_ms`` and ``step_ms_all``, then one JSON summary: the
card's name and power limit, each side's step times, their medians, and
B's median over A's. Full output
goes to ``chiprun_out/tree_ab_<phase>.log``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = ("import chip_smoke as cs, paddlepaddle_tpu_torch as pt; "
       "cs.phase_{phase}(pt)")


def run_once(tree: str, phase: str, log) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(phase=phase)], cwd=tree,
        capture_output=True, text=True, timeout=1200,
        env={**os.environ, "PYTHONPATH": os.path.abspath(tree)})
    log.write(f"== {tree} rc={out.returncode}\n{out.stdout}\n{out.stderr}\n")
    rec = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if obj.get("phase") == phase:
                rec = obj
    if out.returncode != 0 or rec is None:
        raise SystemExit(f"{tree}: phase {phase} failed (rc "
                         f"{out.returncode}): {out.stderr[-2000:]}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="moe_train")
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    args = ap.parse_args()
    os.makedirs("chiprun_out", exist_ok=True)
    times = {"a": [], "b": []}
    with open(f"chiprun_out/tree_ab_{args.phase}.log", "w") as log:
        for side in ("a", "b", "b", "a"):
            rec = run_once(getattr(args, side), args.phase, log)
            times[side].append(rec["step_ms"])
            print(json.dumps({"side": side, "tree": getattr(args, side),
                              "step_ms": rec["step_ms"],
                              "step_ms_all": rec.get("step_ms_all"),
                              "losses": rec.get("losses")}), flush=True)
    med = {s: statistics.median(v) for s, v in times.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"phase": args.phase, "card": card, "step_ms": times,
                      "median_ms": med,
                      "b_over_a": med["b"] / med["a"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
