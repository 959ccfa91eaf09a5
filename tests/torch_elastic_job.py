"""Training scripts the port's launcher runs in ``tests/test_torch_elastic.py``
(imports no JAX and nothing of the JAX package).

``python torch_elastic_job.py elastic``: one incarnation of an elastic job
(``launch --nnodes 1:2``). A ``Linear(4, 1)`` from a seeded init trains
with Momentum on the rows of a ``TensorDataset`` that a
``DistributedBatchSampler`` (shuffled, epoch 0) shards over the live world,
global batch 4; gradients and the loss are summed over the world, each
rank's part carrying the global denominator, so every world takes the same
steps. The incarnation restores the newest valid checkpoint
(``CheckpointManager``), skips the batches it already trained on, trains
to the next stop of ``JOB_STOPS`` (checkpointing each step), writes its
losses and waits to be relaunched; the last one trains to ``JOB_TOTAL``
and exits 0.

``python torch_elastic_job.py drill``: the kill-resume drill of the JAX
package's ``tests/test_elastic.py:121-186`` (host-group all-reduces,
``save`` / ``load`` every step on rank 0, rank 1 killing itself once at
step 6, ``rejoin`` after the restart).
"""

import json
import os
import sys
import time

import numpy as np

ROWS, GLOBAL_BATCH = 24, 4


def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS, 4)).astype(np.float32)
    w_true = np.asarray([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    return x, (x @ w_true + 0.1).astype(np.float32)


def init_weights():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((4, 1)).astype(np.float32) * 0.5,
            np.zeros((1,), np.float32))


def global_batches():
    """The oracle: global batch k is rows ``perm[4k:4k+4]`` of numpy's
    ``default_rng(0)`` shuffle (what every world's sampler gives)."""
    perm = np.arange(ROWS)
    np.random.default_rng(0).shuffle(perm)
    return [perm[k:k + GLOBAL_BATCH] for k in range(0, ROWS, GLOBAL_BATCH)]


def _model():
    import torch

    import paddlepaddle_tpu_torch as pt

    lin = pt.nn.Linear(4, 1, device="cpu")
    w, b = init_weights()
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    opt = pt.Momentum(learning_rate=0.1, momentum=0.9,
                      parameters=lin.named_parameters())
    return lin, opt


def train_steps(lin, opt, loader, start, end, world, on_step=None):
    """Steps ``start..end`` of the schedule on this rank's batches."""
    import torch

    from paddlepaddle_tpu_torch.distributed import all_reduce

    losses = []
    for k, (x, y) in enumerate(loader):
        if k < start:
            continue          # trained on before the checkpoint
        if k >= end:
            break
        loss = ((lin(x) - y) ** 2).sum() / GLOBAL_BATCH
        loss.backward()
        loss = loss.detach().clone()
        if world > 1:
            for p in lin.parameters():
                all_reduce(p.grad)
            all_reduce(loss)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        if on_step is not None:
            on_step(k + 1)
    return losses


def uninterrupted(total=ROWS // GLOBAL_BATCH):
    """One process, no launcher: the losses of the whole schedule."""
    from paddlepaddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                           TensorDataset)

    ds = TensorDataset(list(data()))
    lin, opt = _model()
    loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(
        ds, GLOBAL_BATCH, num_replicas=1, rank=0, shuffle=True),
        device="cpu")
    return train_steps(lin, opt, loader, 0, total, 1)


def elastic_main():
    from paddlepaddle_tpu_torch.distributed import (get_rank, get_world_size,
                                                    init_parallel_env)
    from paddlepaddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                           TensorDataset)
    from paddlepaddle_tpu_torch.resilience import CheckpointManager

    version = int(os.environ["PADDLE_WORLD_VERSION"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    if world > 1:
        init_parallel_env(backend="gloo")
    rank, world = get_rank(), get_world_size()
    out = os.environ["JOB_DIR"]
    total = int(os.environ["JOB_TOTAL"])
    lin, opt = _model()
    opt.init_state()
    params = dict(lin.state_dict())
    mgr = CheckpointManager(os.path.join(out, "ckpt"), keep_last_k=2)
    start = mgr.restore(params) or 0
    if start:
        mgr.restore(opt.checkpoint_state())
    stops = [int(s) for s in os.environ.get("JOB_STOPS", "").split(",") if s]
    end = min([s for s in stops if s > start] + [total])
    ds = TensorDataset(list(data()))
    sampler = DistributedBatchSampler(ds, GLOBAL_BATCH // world, shuffle=True)
    sampler.set_epoch(0)
    seen = []

    def save(step):
        state = dict(params)
        state.update(opt.checkpoint_state())
        mgr.save(state, step)

    class Recording(DataLoader):
        def __iter__(self):
            for batch in super().__iter__():
                seen.append(batch[0].numpy().tolist())
                yield batch

    loader = Recording(ds, batch_sampler=sampler, device="cpu")
    losses = train_steps(lin, opt, loader, start, end, world, on_step=save)
    with open(os.path.join(out, f"v{version}.rank{rank}.json"), "w") as f:
        json.dump({"version": version, "world": world, "rank": rank,
                   "start": start, "end": end, "losses": losses,
                   "rows": seen[start:end],
                   "restart": int(os.environ.get("PADDLE_RESTART_NUM", 0))},
                  f)
    if end < total:
        while True:           # the launcher relaunches this world's workers
            time.sleep(0.2)


def drill_main():
    import torch

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed.host_collectives import (
        get_host_group)

    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    ckpt, marker = os.environ["DRILL_CKPT"], os.environ["DRILL_MARKER"]
    total = 10
    g = get_host_group() if world > 1 else None
    lin, opt = _model()
    start = 0
    if os.path.exists(ckpt):
        blob = pt.load(ckpt, device="cpu")
        lin.load_state_dict(blob["model"])
        opt.set_state_dict(blob["opt"])
        start = int(blob["step"])
        if g is not None:
            # one all-reduce a parameter a finished step: the op index the
            # peers reached at the checkpoint
            g.rejoin(start * len(list(lin.parameters())))
    x, _ = data()
    x = x[:16]
    y = x @ np.asarray([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    loss_val = None
    for step in range(start, total):
        if rank == 1 and step == 6 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(7)       # a failure after the checkpoint of step 6
        loss = ((lin(xb) - yb) ** 2).mean()
        loss.backward()
        if g is not None:
            for p in lin.parameters():
                p.grad = torch.from_numpy(
                    g.all_reduce(p.grad.numpy(), op="sum") / world)
        opt.step()
        opt.clear_grad()
        loss_val = float(loss)
        if rank == 0:
            tmp = ckpt + ".tmp"
            pt.save({"model": lin.state_dict(), "opt": opt.state_dict(),
                     "step": step + 1}, tmp)
            os.replace(tmp, ckpt)
    if rank == 0:
        with open(os.environ["DRILL_OUT"], "w") as f:
            f.write(repr(loss_val))
    print(f"DRILL_RANK{rank}_DONE loss={loss_val}", flush=True)


if __name__ == "__main__":
    {"elastic": elastic_main, "drill": drill_main}[sys.argv[1]]()
