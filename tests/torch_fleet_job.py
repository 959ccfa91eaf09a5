"""The worker ``tests/test_torch_fleet_telemetry.py`` launches with
``--obs_export`` (imports no JAX): it traces, fetches a batch a step from a
``DataLoader`` inside a ``train_step`` span (so every rank has series and
spans), and records a ``go_seen`` span the moment the file ``DRILL_GO``
appears, until ``DRILL_STOP`` appears."""

import os
import sys
import time

os.environ.setdefault("PADDLE_OBS_TRACE", "1")   # publish traces too

import numpy as np  # noqa: E402

import paddlepaddle_tpu_torch.observability as obs  # noqa: E402
from paddlepaddle_tpu_torch.io import DataLoader, TensorDataset  # noqa: E402


def main():
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    go, stop = os.environ["DRILL_GO"], os.environ["DRILL_STOP"]
    ds = TensorDataset([np.arange(64, dtype=np.int64).reshape(32, 2)])
    loader = DataLoader(ds, batch_size=4, device="cpu")
    seen_go = False
    deadline = time.time() + 240
    while not os.path.exists(stop) and time.time() < deadline:
        for (batch,) in loader:
            with obs.RecordEvent("train_step"):
                batch.sum()
            if not seen_go and os.path.exists(go):
                with obs.RecordEvent("go_seen"):
                    pass
                seen_go = True
            time.sleep(0.01)
            if os.path.exists(stop):
                break
    print(f"FLEET_RANK{rank}_DONE", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
