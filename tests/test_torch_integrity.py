"""Checkpoint integrity and fault handling around the port's distributed
checkpoint: ``resilience.integrity`` (``paddlepaddle_tpu/resilience/
integrity.py``), the checkpoint's chaos seam and retry policy, the
preemption drain and the step watchdog, as the reference's
``tests/test_resilience.py`` holds them, ported case by case:

* format v3's CRC records, a bit flip caught by ``validate_checkpoint``
  and by the load, the ``FLAGS_ckpt_verify_crc`` opt-out, an uncommitted
  directory, an overwrite that never tears, a kill during a save (a chaos
  kill at ``ckpt.write_shard`` in a child process);
* ``CheckpointManager``: keep-last-K with newest-valid fallback (counted
  in ``paddle_ckpt_fallbacks_total``), ``__old__`` recovery, an empty
  root;
* ``wait_all_saves`` aggregating every async failure, one failure raised
  as it is;
* SIGTERM: the emergency save, then the async writers drained
  (``resilience/preemption.py``), then exit 143;
* the watchdog's re-arm, one fire per hung step, and the ``step`` seam;
* the elastic drill of the reference's ``tests/test_chaos_elastic.py`` on
  the port's ``launch --max_restarts`` (marked slow, as there).

The same directory is also validated by the JAX package's
``validate_checkpoint``, whose rules the port's copy keeps.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddlepaddle_tpu.resilience.integrity import \
    CheckpointCorruptionError as JCorruption
from paddlepaddle_tpu.resilience.integrity import \
    validate_checkpoint as jvalidate

from paddlepaddle_tpu_torch.core import flags
from paddlepaddle_tpu_torch.distributed import checkpoint as dist_ckpt
from paddlepaddle_tpu_torch.observability import get_registry
from paddlepaddle_tpu_torch.resilience import chaos
from paddlepaddle_tpu_torch.resilience.chaos import ChaosError
from paddlepaddle_tpu_torch.resilience.integrity import (
    CheckpointCorruptionError,
    CheckpointManager,
    find_latest_valid_checkpoint,
    list_checkpoints,
    validate_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _chaos_off():
    chaos.disable()
    yield
    chaos.disable()


def _counter_value(name, **labels):
    m = get_registry().get(name)
    return m.value(**labels) if m is not None else 0


def _state(n=4):
    m = torch.nn.Linear(n, n)
    return m, m.state_dict()


def _set(t, value):
    with torch.no_grad():
        t.fill_(value)


def _flip_byte(fpath, offset=-3):
    with open(fpath, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _weight_file(path):
    meta = dist_ckpt.get_checkpoint_metadata(path)
    return os.path.join(path, meta["tensors"]["weight"]["shards"][0]["file"])


def test_v3_metadata_records_crc(tmp_path):
    _, sd = _state()
    ck = str(tmp_path / "ckpt")
    dist_ckpt.save_state_dict(sd, ck)
    meta = dist_ckpt.get_checkpoint_metadata(ck)
    assert meta["format"].endswith("v3")
    for rec in meta["tensors"].values():
        for s in rec["shards"]:
            assert isinstance(s["crc32"], int)
    assert validate_checkpoint(ck) == meta == jvalidate(ck)


def test_bitflip_detected_on_validate_and_load(tmp_path):
    _, sd = _state()
    ck = str(tmp_path / "ckpt")
    dist_ckpt.save_state_dict(sd, ck)
    _flip_byte(_weight_file(ck))
    before = _counter_value("paddle_ckpt_corruption_detected_total")
    with pytest.raises(CheckpointCorruptionError, match="CRC mismatch"):
        validate_checkpoint(ck)
    with pytest.raises(JCorruption, match="CRC mismatch"):
        jvalidate(ck)
    with pytest.raises(CheckpointCorruptionError, match="CRC mismatch"):
        dist_ckpt.load_state_dict(_state()[1], ck)
    assert _counter_value("paddle_ckpt_corruption_detected_total") \
        >= before + 2


def test_crc_verify_flag_opt_out(tmp_path):
    _, sd = _state()
    ck = str(tmp_path / "ckpt")
    dist_ckpt.save_state_dict(sd, ck)
    _flip_byte(_weight_file(ck))
    flags.set_flags({"FLAGS_ckpt_verify_crc": False})
    try:
        dist_ckpt.load_state_dict(_state()[1], ck)  # no CRC gate: loads
        validate_checkpoint(ck)
    finally:
        flags.set_flags({"FLAGS_ckpt_verify_crc": True})


def test_uncommitted_dir_is_invalid(tmp_path):
    d = tmp_path / "torn"
    d.mkdir()
    (d / "weight.npy").write_bytes(b"partial")
    with pytest.raises(CheckpointCorruptionError, match="no metadata.json"):
        validate_checkpoint(str(d))


def test_atomic_commit_overwrite_never_torn(tmp_path):
    ck = str(tmp_path / "ckpt")
    _, sd1 = _state()
    dist_ckpt.save_state_dict(sd1, ck)
    w1 = sd1["weight"].clone()
    _, sd2 = _state()
    dist_ckpt.save_state_dict(sd2, ck)      # overwrite
    validate_checkpoint(ck)
    _, sd3 = _state()
    dist_ckpt.load_state_dict(sd3, ck)
    assert torch.equal(sd3["weight"], sd2["weight"])
    assert not torch.equal(sd3["weight"], w1)
    leftovers = [n for n in os.listdir(tmp_path)
                 if "staging" in n or "__old__" in n]
    assert leftovers == []


def test_kill_during_save_leaves_no_torn_checkpoint(tmp_path):
    """A chaos kill inside the first shard write: the target is absent
    and no directory holds a metadata.json."""
    ck = str(tmp_path / "ckpt")
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import torch\n"
            "from paddlepaddle_tpu_torch.distributed import checkpoint as c\n"
            "m = torch.nn.Linear(8, 8)\n"
            f"c.save_state_dict(m.state_dict(), {ck!r})\n")
    env = dict(os.environ, PADDLE_CHAOS_POINTS="ckpt.write_shard:kill:@1:77",
               PADDLE_CHAOS_SEED="1234")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 77, (proc.returncode, proc.stderr[-2000:])
    assert not os.path.exists(ck)
    for root, _dirs, files in os.walk(tmp_path):
        assert "metadata.json" not in files, f"torn metadata in {root}"
    with pytest.raises(CheckpointCorruptionError):
        validate_checkpoint(ck)


def test_manager_keeps_last_k_and_restores_newest(tmp_path):
    root = str(tmp_path / "run")
    mgr = CheckpointManager(root, keep_last_k=3)
    _, sd = _state()
    for step in range(1, 6):
        _set(sd["weight"], float(step))
        mgr.save(sd, step)
    assert [s for s, _ in list_checkpoints(root)] == [5, 4, 3]
    _, sd2 = _state()
    assert mgr.restore(sd2) == 5
    assert torch.all(sd2["weight"] == 5.0)


def test_manager_falls_back_past_corrupt_newest(tmp_path):
    root = str(tmp_path / "run")
    mgr = CheckpointManager(root, keep_last_k=3)
    _, sd = _state()
    for step in range(1, 4):
        _set(sd["weight"], float(step))
        mgr.save(sd, step)
    _flip_byte(_weight_file(mgr.step_path(3)))
    before = _counter_value("paddle_ckpt_fallbacks_total")
    assert find_latest_valid_checkpoint(root)[0] == 2
    _, sd2 = _state()
    assert mgr.restore(sd2) == 2
    assert torch.all(sd2["weight"] == 2.0)
    assert _counter_value("paddle_ckpt_fallbacks_total") > before


def test_manager_recovers_old_dir_from_interrupted_overwrite(tmp_path):
    root = str(tmp_path / "run")
    mgr = CheckpointManager(root, keep_last_k=3)
    _, sd = _state()
    _set(sd["weight"], 3.0)
    mgr.save(sd, 3)
    os.rename(mgr.step_path(3), mgr.step_path(3) + ".__old__.999")
    assert find_latest_valid_checkpoint(root)[0] == 3
    _, sd2 = _state()
    assert mgr.restore(sd2) == 3
    assert torch.all(sd2["weight"] == 3.0)
    mgr.save(sd, 3)
    assert not os.path.exists(mgr.step_path(3) + ".__old__.999")
    assert os.path.exists(mgr.step_path(3))


def test_manager_restore_empty_root(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"), keep_last_k=2)
    assert mgr.restore(_state()[1]) is None
    assert mgr.latest_valid() is None
    with pytest.raises(ValueError, match="keep_last_k"):
        CheckpointManager(str(tmp_path), keep_last_k=0)


def test_manager_keeps_an_uncommitted_dir_a_writer_may_own(tmp_path):
    """The `_maybe_in_flight` grace: an uncommitted dir modified just now
    may be a lagging async save, and GC leaves it."""
    root = tmp_path / "run"
    mgr = CheckpointManager(str(root), keep_last_k=1)
    _, sd = _state()
    for step in (1, 2):
        mgr.save(sd, step)
    (root / "step-0").mkdir()                 # fresh, uncommitted
    mgr.gc()
    assert sorted(os.listdir(root)) == ["step-0", "step-2"]
    old = time.time() - 3600
    os.utime(root / "step-0", (old, old))
    mgr.gc()
    assert sorted(os.listdir(root)) == ["step-2"]


def test_wait_all_saves_aggregates_all_failures(tmp_path):
    _, sd = _state()
    # 2 shard files a save, 3 attempts a file: x6 fails the first file of
    # both async saves through their retries
    chaos.configure("ckpt.write_shard:exc:x6")
    dist_ckpt.save_state_dict(sd, str(tmp_path / "a"), async_save=True)
    dist_ckpt.save_state_dict(sd, str(tmp_path / "b"), async_save=True)
    with pytest.raises(dist_ckpt.CheckpointSaveError,
                       match="2 async checkpoint saves failed") as ei:
        dist_ckpt.wait_all_saves()
    assert len(ei.value.errors) == 2
    assert all(isinstance(e, ChaosError) for e in ei.value.errors)
    dist_ckpt.wait_all_saves()                # not poisoned
    chaos.disable()
    dist_ckpt.save_state_dict(sd, str(tmp_path / "c"), async_save=True)
    dist_ckpt.wait_all_saves()
    validate_checkpoint(str(tmp_path / "c"))


def test_single_async_failure_reraised_as_is(tmp_path):
    _, sd = _state()
    chaos.configure("ckpt.write_shard:exc:x3")   # one save, all 3 attempts
    dist_ckpt.save_state_dict(sd, str(tmp_path / "a"), async_save=True)
    with pytest.raises(ChaosError):
        dist_ckpt.wait_all_saves()


def test_shard_write_retries_a_transient_fault(tmp_path):
    _, sd = _state()
    before = _counter_value("paddle_retry_attempts_total",
                            op="ckpt.write_shard")
    chaos.configure("ckpt.write_shard:exc:x2")   # two failures, then fine
    dist_ckpt.save_state_dict(sd, str(tmp_path / "a"))
    validate_checkpoint(str(tmp_path / "a"))
    assert _counter_value("paddle_retry_attempts_total",
                          op="ckpt.write_shard") == before + 2


def test_preemption_sigterm_saves_drains_and_exits_restartable(tmp_path):
    """SIGTERM: the emergency async save, the writers drained by the
    handler, exit 143; the checkpoint is complete."""
    ck = str(tmp_path / "emergency")
    code = (f"import sys, time; sys.path.insert(0, {REPO!r})\n"
            "import torch\n"
            "from paddlepaddle_tpu_torch.distributed import checkpoint as c\n"
            "from paddlepaddle_tpu_torch.resilience import "
            "install_preemption_handler\n"
            "m = torch.nn.Linear(256, 256)\n"
            "install_preemption_handler(\n"
            f"    lambda: c.save_state_dict(m.state_dict(), {ck!r}, "
            "async_save=True))\n"
            "print('READY', flush=True)\n"
            "time.sleep(120)\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
    assert rc == 143, (rc, proc.stderr.read()[-2000:])
    validate_checkpoint(ck)
    dist_ckpt.load_state_dict(torch.nn.Linear(256, 256).state_dict(), ck)


# -- the step watchdog (reference tests/test_resilience.py:539-585) ----------

def test_watchdog_rearms_after_timed_out_step_retires():
    from paddlepaddle_tpu_torch.distributed.watchdog import Watchdog

    fired = []
    before = _counter_value("paddle_watchdog_step_timeouts_total",
                            step="slow")
    wd = Watchdog(timeout=0.2, poll_interval=0.05, abort=False,
                  on_timeout=lambda name, el: fired.append(name))
    with wd:
        with wd.step("slow"):
            time.sleep(0.5)
        with wd.step("fast"):
            time.sleep(0.01)
        with wd.step("slow"):
            time.sleep(0.5)
    assert fired == ["slow", "slow"]
    assert _counter_value("paddle_watchdog_step_timeouts_total",
                          step="slow") == before + 2


def test_watchdog_fires_once_per_hung_step():
    from paddlepaddle_tpu_torch.distributed.watchdog import Watchdog

    fired = []
    wd = Watchdog(timeout=0.1, poll_interval=0.02, abort=False,
                  on_timeout=lambda name, el: fired.append(name))
    with wd:
        with wd.step("hung"):
            time.sleep(0.6)
    assert fired == ["hung"]


def test_step_chaos_seam():
    from paddlepaddle_tpu_torch.distributed.watchdog import Watchdog

    chaos.configure("step:exc:@1")
    wd = Watchdog(timeout=30, abort=False)
    with wd:
        with pytest.raises(ChaosError):
            with wd.step("s"):
                pass


# -- the elastic drill (reference tests/test_chaos_elastic.py) ---------------

_WORKER = r"""
import os, sys, time
sys.path.insert(0, os.environ["REPO_DIR"])
import numpy as np
import torch
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed.host_collectives import get_host_group
from paddlepaddle_tpu_torch.resilience import CheckpointManager, chaos
from paddlepaddle_tpu_torch.resilience.chaos import chaos_point
from paddlepaddle_tpu_torch.resilience.integrity import \
    find_latest_valid_checkpoint

rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
incarnation = int(os.environ.get("PADDLE_RESTART_NUM", "0"))
root = os.environ["DRILL_ROOT"]
kill_step = int(os.environ.get("DRILL_KILL_STEP", "-1"))
TOTAL = 10

if rank == 1 and incarnation == 0 and kill_step >= 0:
    chaos.configure("preempt:kill:@1:77",
                    seed=int(os.environ.get("PADDLE_CHAOS_SEED", "0")))

g = get_host_group() if world > 1 else None
mgr = CheckpointManager(root, keep_last_k=3)
torch.manual_seed(0)
lin = torch.nn.Linear(4, 1)
opt = pt.SGD(learning_rate=0.1, parameters=list(lin.named_parameters()))
start = mgr.restore(lin.state_dict()) or 0
if g is not None and start:
    g.rejoin(start * len(list(lin.parameters())))
rng = np.random.default_rng(0)
xb = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
yb = xb @ torch.tensor([[1.0], [2.0], [-1.0], [0.5]])
loss_val = None
for step in range(start, TOTAL):
    if rank == 1 and incarnation == 0 and step == kill_step:
        deadline = time.time() + 60
        while time.time() < deadline:
            latest = find_latest_valid_checkpoint(root)
            if latest is not None and latest[0] >= step:
                break
            time.sleep(0.05)
        chaos_point("preempt")            # armed above: os._exit(77)
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
        mgr.save(lin.state_dict(), step + 1, process_index=0,
                 process_count=1)
if rank == 0:
    with open(os.environ["DRILL_OUT"], "w") as f:
        f.write(repr(loss_val))
print(f"CHAOS_RANK{rank}_DONE loss={loss_val} incarnation={incarnation}")
"""


def _drill(tmp_path, tag, world, kill_step):
    d = tmp_path / tag
    d.mkdir()
    script = d / "train.py"
    script.write_text(_WORKER)
    env = dict(os.environ, REPO_DIR=REPO, PADDLE_CHAOS_SEED="1234",
               DRILL_ROOT=str(d / "ckpts"),
               DRILL_OUT=str(d / "final_loss.txt"),
               DRILL_KILL_STEP=str(kill_step))
    out = subprocess.run(
        [sys.executable, "-m", "paddlepaddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(world), "--max_restarts", "2", str(script)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out, d, float((d / "final_loss.txt").read_text())


@pytest.mark.slow
def test_injected_kill_resumes_from_checkpoint_matching_loss(tmp_path):
    out, d, interrupted = _drill(tmp_path, "duo_kill", world=2, kill_step=6)
    assert "worker 1 exited 77" in out.stderr
    assert "restart 1/2" in out.stderr
    _out2, _d2, baseline = _drill(tmp_path, "solo", world=1, kill_step=-1)
    np.testing.assert_allclose(interrupted, baseline, rtol=1e-6)
    root = str(d / "ckpts")
    assert [s for s, _ in list_checkpoints(root)] == [10, 9, 8]
    mgr = CheckpointManager(root, keep_last_k=3)
    _flip_byte(_weight_file(mgr.step_path(10)))
    assert mgr.restore(torch.nn.Linear(4, 1).state_dict()) == 9
