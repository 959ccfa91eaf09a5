"""The port's distributed checkpoint (``paddlepaddle_tpu_torch/distributed/
checkpoint``) on the CPU against the JAX package's
(``paddlepaddle_tpu/distributed/checkpoint/__init__.py``, format v3).

* **The format both ways.** The same f32, int64 and bf16 state dicts
  through both packages' saves give byte-equal shard files and an equal
  ``metadata.json`` (CRCs included); the JAX package loads the port's
  f32, int64, f16, int32 and bool checkpoints and the port the JAX
  package's, bit-exact (every dtype the reference round-trips). Two
  simulated ranks of ``LocalShards`` (``process_index`` /
  ``process_count`` in one process, as reference
  ``tests/test_checkpoint.py:132``) merge into the same files and
  metadata in both packages.
* **bf16** (ROADMAP, fifth divergence): the port writes the reference's
  bytes (descr ``'<V2'``, ``"dtype": "bfloat16"``) and reads them back as
  ``torch.bfloat16``, against a numpy oracle (the high 16 bits of the f32
  value); the reference's own load cannot read such a file.
* **Reshard-on-load into DTensors.** The JAX package's ``dp4 x tp2``
  jax-sharded save (reference ``tests/test_checkpoint.py:91``'s values)
  loaded by the port into DTensors on ``dp2 x fsdp2 x tp2``: each of the
  8 ranks (a fake process group of that world, one rank after another in
  one process) gets its block bit-exact.
* **A ``ShardedTrainStep`` through a checkpoint.** A tiny f32 Llama
  (vocab 65: the embedding's fsdp dim does not split, an uneven cut kept
  whole) trains 2 steps on ``fsdp2`` (2 SPMD gloo ranks, rank bodies in
  ``tests/torch_dist_workers.py``), saves asynchronously (each rank its
  blocks, rank 0 merging) and trains a third step beside the write; the
  checkpoint, loaded into one process (``TrainStep``) and into ``mp2`` (a
  single-process step: the load reaches its worker rank), trains that
  third step again. Every third loss against the JAX package's
  uninterrupted 3-step ``ShardedTrainStep`` on the same weights (rtol
  1e-5).
* The reference's own checkpoint cases: the async save, the multi-host
  merge timeout, the process-exit flush, a shape mismatch.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed import checkpoint as jckpt

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import checkpoint as tckpt
from paddlepaddle_tpu_torch.distributed import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(dtype):
    rng = np.random.default_rng(len(dtype))
    if dtype in ("int64", "int32"):
        return {"w": rng.integers(-99, 99, (4, 3)).astype(dtype),
                "b": rng.integers(0, 9, (5,)).astype(dtype),
                "s": np.asarray(7, dtype)}
    if dtype == "bool":
        return {"w": rng.random((4, 3)) > 0.5, "b": rng.random(5) > 0.5,
                "s": np.asarray(True)}
    f = "float16" if dtype == "float16" else "float32"
    return {"w": rng.standard_normal((4, 3)).astype(f),
            "b": rng.standard_normal((5,)).astype(f),
            "s": np.asarray(2.5, f)}


def _jax_sd(vals, dtype):
    out = {}
    for k, v in vals.items():
        t = paddle.to_tensor(np.asarray(v))
        out[k] = t.astype("bfloat16") if dtype == "bfloat16" else t
    return out


def _torch_sd(vals, dtype):
    out = {}
    for k, v in vals.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.bfloat16() if dtype == "bfloat16" else t
    return out


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_both_saves_write_the_same_bytes(tmp_path, dtype):
    vals = _values(dtype)
    jckpt.save_state_dict(_jax_sd(vals, dtype), str(tmp_path / "j"))
    tckpt.save_state_dict(_torch_sd(vals, dtype), str(tmp_path / "t"))
    fj, ft = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert set(fj) == set(ft) == {"metadata.json", "w.npy", "b.npy",
                                  "s.npy"}
    for name in fj:
        assert fj[name] == ft[name], name
    meta = json.loads(ft["metadata.json"])
    assert meta["format"] == "paddlepaddle_tpu.dist_ckpt.v3"
    assert meta["tensors"]["w"]["dtype"] == dtype
    assert all(isinstance(s["crc32"], int) for r in meta["tensors"].values()
               for s in r["shards"])


@pytest.mark.parametrize("dtype", ["float32", "int64", "float16", "int32",
                                   "bool"])
def test_each_package_loads_the_others_checkpoint(tmp_path, dtype):
    vals = _values(dtype)
    jckpt.save_state_dict(_jax_sd(vals, dtype), str(tmp_path / "j"))
    tckpt.save_state_dict(_torch_sd(vals, dtype), str(tmp_path / "t"))
    into_port = {k: torch.zeros_like(torch.from_numpy(np.array(v)))
                 for k, v in vals.items()}
    tckpt.load_state_dict(into_port, str(tmp_path / "j"))
    into_jax = {k: paddle.to_tensor(np.zeros_like(np.asarray(v)))
                for k, v in vals.items()}
    jckpt.load_state_dict(into_jax, str(tmp_path / "t"))
    for k, v in vals.items():
        np.testing.assert_array_equal(into_port[k].numpy(), v)
        np.testing.assert_array_equal(into_jax[k].numpy(), v)
        assert into_port[k].dtype == torch.from_numpy(np.array(v)).dtype


def _bf16_oracle(x: np.ndarray) -> np.ndarray:
    """The bf16 words of ``x`` rounded to nearest even, as uint16 (the
    high 16 bits of the f32 value after rounding)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = u + 0x7FFF + ((u >> 16) & 1)
    return (u >> 16).astype(np.uint16)


def test_bf16_round_trip_against_numpy_oracle(tmp_path):
    """The fifth divergence: the port reads the reference's bf16 file
    back as torch.bfloat16, bit-exact."""
    x = np.random.default_rng(9).standard_normal((6, 5)).astype(np.float32)
    jckpt.save_state_dict({"w": paddle.to_tensor(x).astype("bfloat16")},
                          str(tmp_path / "j"))
    tckpt.save_state_dict({"w": torch.from_numpy(x).bfloat16()},
                          str(tmp_path / "t"))
    words = _bf16_oracle(x)
    for d in ("j", "t"):
        raw = np.load(tmp_path / d / "w.npy")
        assert raw.dtype == np.dtype("V2")
        np.testing.assert_array_equal(raw.view(np.uint16), words)
        out = {"w": torch.zeros(6, 5, dtype=torch.bfloat16)}
        tckpt.load_state_dict(out, str(tmp_path / d))
        np.testing.assert_array_equal(
            out["w"].view(torch.int16).numpy().view(np.uint16), words)
        into_f32 = {"w": torch.zeros(6, 5)}
        tckpt.load_state_dict(into_f32, str(tmp_path / d))
        np.testing.assert_array_equal(
            into_f32["w"].numpy().view(np.uint32) >> 16, words)
        host = {"w": None}
        tckpt.load_state_dict(host, str(tmp_path / d))
        assert host["w"].dtype == torch.bfloat16
    # what the reference's own load does with it (ROADMAP, the divergence)
    with pytest.raises(ValueError, match="cast"):
        jckpt.load_state_dict(
            {"w": paddle.to_tensor(np.zeros((6, 5), np.float32))
             .astype("bfloat16")}, str(tmp_path / "t"))


def test_two_ranks_of_local_shards_merge_alike(tmp_path):
    """Reference tests/test_checkpoint.py:132 in both packages: rank 1
    first, then the coordinator; the same files and metadata."""
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = np.arange(3, dtype=np.float32)
    for pkg, d in ((jckpt, "j"), (tckpt, "t")):
        ck = str(tmp_path / d)
        pkg.save_state_dict(
            {"w": pkg.LocalShards((4, 3), "float32",
                                  [([[2, 4], [0, 3]], w[2:4])]),
             "b": pkg.LocalShards((3,), "float32", [([[0, 3]], b)])},
            ck, process_index=1, process_count=2)
        pkg.save_state_dict(
            {"w": pkg.LocalShards((4, 3), "float32",
                                  [([[0, 2], [0, 3]], w[0:2])]),
             "b": pkg.LocalShards((3,), "float32", [([[0, 3]], b)])},
            ck, process_index=0, process_count=2)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    meta = tckpt.get_checkpoint_metadata(str(tmp_path / "t"))
    assert meta["world_size"] == 2
    assert len(meta["tensors"]["w"]["shards"]) == 2
    assert len(meta["tensors"]["b"]["shards"]) == 1
    out = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    tckpt.load_state_dict(out, str(tmp_path / "j"))
    np.testing.assert_array_equal(out["w"].numpy(), w)
    np.testing.assert_array_equal(out["b"].numpy(), b)
    # torch blocks in LocalShards write the same bytes
    ck = str(tmp_path / "tt")
    for r, rows in ((1, slice(2, 4)), (0, slice(0, 2))):
        tckpt.save_state_dict(
            {"w": tckpt.LocalShards(
                (4, 3), "float32",
                [([[rows.start, rows.stop], [0, 3]],
                  torch.from_numpy(w[rows]))]),
             "b": tckpt.LocalShards((3,), "float32",
                                    [([[0, 3]], torch.from_numpy(b))])},
            ck, process_index=r, process_count=2)
    assert _files(tmp_path / "tt") == _files(tmp_path / "t")


def test_merge_times_out_on_a_missing_rank(tmp_path):
    with pytest.raises(TimeoutError, match="rank"):
        tckpt.save_state_dict(
            {"w": tckpt.LocalShards((2,), "float32",
                                    [([[0, 2]], np.zeros(2, np.float32))])},
            str(tmp_path / "ckpt"), process_index=0, process_count=2,
            merge_timeout=0.3)


def test_jax_sharded_save_loads_into_dtensors_on_another_mesh(tmp_path):
    """Reference tests/test_checkpoint.py:91's values saved by the JAX
    package on dp4 x tp2, loaded by the port into DTensors on
    dp2 x fsdp2 x tp2: every rank's block bit-exact."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddlepaddle_tpu.distributed.mesh import ProcessMesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(7)
    vals = {"wq": rng.standard_normal((16, 8)).astype(np.float32),
            "wo": rng.standard_normal((8, 16)).astype(np.float32),
            "scale": rng.standard_normal((16,)).astype(np.float32)}
    mesh_a = ProcessMesh(shape=[4, 2], dim_names=["dp", "tp"]).to_jax()
    specs_a = {"wq": P(None, "tp"), "wo": P("tp", None), "scale": P()}
    sd = {}
    for k, v in vals.items():
        t = paddle.to_tensor(v.copy())
        t._replace_data(jax.device_put(t._data,
                                       NamedSharding(mesh_a, specs_a[k])))
        sd[k] = t
    ck = str(tmp_path / "ckpt")
    jckpt.save_state_dict(sd, ck, async_save=True)
    jckpt.wait_all_saves()
    assert len(tckpt.get_checkpoint_metadata(ck)["tensors"]["wq"]
               ["shards"]) == 2
    # P(("dp", "fsdp"), "tp"), P("tp", "fsdp"), P("fsdp") as placements
    specs_b = {"wq": [("S", 0), ("S", 0), ("S", 1)],
               "wo": [("R",), ("S", 1), ("S", 0)],
               "scale": [("R",), ("S", 0), ("R",)]}
    out = str(tmp_path / "blocks.pkl")
    code = (f"import sys; sys.path[:0] = [{REPO!r}, "
            f"{os.path.join(REPO, 'tests')!r}]\n"
            "import torch_dist_workers as W\n"
            f"W.fake_dtensor_load({ck!r}, [2, 2, 2], ['dp', 'fsdp', 'tp'], "
            f"{specs_b!r}, {dict((k, v.shape) for k, v in vals.items())!r}, "
            f"{out!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    blocks = pickle.loads(open(out, "rb").read())
    assert sorted(blocks) == list(range(8))
    for r, got in blocks.items():
        dp, fsdp, tp = got["coord"]
        want = {"wq": vals["wq"][(2 * dp + fsdp) * 4:(2 * dp + fsdp + 1) * 4,
                                 tp * 4:(tp + 1) * 4],
                "wo": vals["wo"][tp * 4:(tp + 1) * 4,
                                 fsdp * 8:(fsdp + 1) * 8],
                "scale": vals["scale"][fsdp * 8:(fsdp + 1) * 8]}
        for k, v in want.items():
            np.testing.assert_array_equal(got["local"][k], v,
                                          err_msg=f"rank {r} {k}")


def test_async_save_snapshots_before_returning(tmp_path):
    """The port's optimizers update in place: what an async save writes is
    the state at the call, whatever happens to the tensors after it."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    want = w.clone()
    tckpt.save_state_dict({"w": w}, str(tmp_path / "a"), async_save=True)
    w.add_(100.0)                                # an update right after
    tckpt.wait_all_saves()
    out = {"w": torch.zeros(3, 4)}
    tckpt.load_state_dict(out, str(tmp_path / "a"))
    assert torch.equal(out["w"], want)


def test_load_fills_the_model_in_place_and_checks_shapes(tmp_path):
    m = torch.nn.Linear(4, 3)
    tckpt.save_state_dict(m.state_dict(), str(tmp_path / "ck"))
    m2 = torch.nn.Linear(4, 3)
    tckpt.load_state_dict(m2.state_dict(), str(tmp_path / "ck"))
    assert torch.equal(m2.weight, m.weight) and torch.equal(m2.bias, m.bias)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_state_dict(torch.nn.Linear(4, 2).state_dict(),
                              str(tmp_path / "ck"))
    with pytest.raises(KeyError, match="lacks keys"):
        tckpt.load_state_dict({"other": torch.zeros(1)},
                              str(tmp_path / "ck"))


def test_async_save_flushed_at_process_exit(tmp_path):
    """Reference tests/test_checkpoint.py:176: a process that async-saves
    and exits without waiting still leaves a complete checkpoint."""
    ck = str(tmp_path / "ckpt")
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import torch\n"
            "from paddlepaddle_tpu_torch.distributed import checkpoint as c\n"
            "m = torch.nn.Linear(64, 64)\n"
            f"c.save_state_dict(m.state_dict(), {ck!r}, async_save=True)\n"
            "sys.exit(0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tckpt.load_state_dict(torch.nn.Linear(64, 64).state_dict(), ck)


# -- a ShardedTrainStep through a checkpoint ----------------------------------

def _jax_state():
    from paddlepaddle_tpu.models import LlamaConfig, LlamaForCausalLM

    cfg = W.CKPT_CFG
    paddle.seed(11)
    m = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        max_len=cfg["max_position_embeddings"]))
    return m, {k: np.asarray(v).astype(np.float32)
               for k, v in m.functional_state().items()
               if k not in ("model.rope_cos", "model.rope_sin")}


def _batch():
    ids = np.random.default_rng(2).integers(0, 65, (4, 16)).astype(np.int64)
    labels = ids.copy()
    labels[1, :11] = -100
    return ids, labels


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """The reference's 4 uninterrupted losses; the SPMD fsdp2 save after
    2 steps; its third and fourth steps resumed in one process and on mp2
    (the fourth reads the optimizer state the load gave the third)."""
    from paddlepaddle_tpu.distributed.mesh import ProcessMesh as JMesh
    from paddlepaddle_tpu.models.llama import llama_sharding_rules as jrules
    from paddlepaddle_tpu.optimizer import AdamW as JAdamW
    from paddlepaddle_tpu.parallel import ShardedTrainStep as JStep

    ids, labels = _batch()
    m, state = _jax_state()
    jopt = JAdamW(learning_rate=1e-3, parameters=m.parameters(),
                  grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    jstep = JStep(m, jopt, lambda mm, i, l: mm(i, labels=l),
                  mesh=JMesh(shape=[2], dim_names=["fsdp"]),
                  rules=jrules(), data_axes=("dp", "fsdp"))
    ref = [float(jstep(ids.astype(np.int32), labels.astype(np.int32))
                 .numpy()) for _ in range(4)]
    path = str(tmp_path_factory.mktemp("ckpt") / "step2")
    spmd = spawn(W.ckpt_fsdp_session, args=(state, ids, labels, path),
                 nprocs=2, timeout=300, pg_timeout=120)
    ids_t, lab_t = torch.from_numpy(ids), torch.from_numpy(labels)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # one process: a TrainStep filled in place from the fsdp2 files
        model = W.port_llama({k: np.zeros_like(v) for k, v in state.items()},
                             "float32", W.CKPT_CFG)
        one = pt.TrainStep(model, pt.AdamW(
            learning_rate=1e-3, parameters=model.named_parameters(),
            grad_clip=pt.ClipGradByGlobalNorm(0.5)),
            lambda mm, i, l: mm(i, labels=l), device="cpu")
        tckpt.load_state_dict(model.state_dict(), path)
        tckpt.load_state_dict(one.optimizer.checkpoint_state(), path)
        step_at_load = one.optimizer._step_count
        one_losses = [float(one(ids_t, lab_t)) for _ in range(2)]
        # mp2, single-process: the load reaches the worker rank
        step = W.ckpt_step({k: np.zeros_like(v) for k, v in state.items()},
                           [2], ["mp"], "mp")
        try:
            tckpt.load_state_dict(step.state_dict(), path)
            mp2_losses = [float(step(ids_t, lab_t)) for _ in range(2)]
            mp2_count = step.optimizer._step_count
        finally:
            step.close()
    finally:
        torch.set_num_threads(threads)
    return {"ref": ref, "spmd": spmd, "one": one_losses, "mp2": mp2_losses,
            "step_at_load": step_at_load, "mp2_count": mp2_count,
            "meta": tckpt.get_checkpoint_metadata(path)}


def test_fsdp2_steps_match_the_reference(resumed):
    for r in resumed["spmd"]:
        np.testing.assert_allclose(r["losses"], resumed["ref"][:3],
                                   rtol=1e-5)


def test_reload_restores_every_ranks_bits(resumed):
    """The third step moved every rank's state after the async save, and
    the load gives back the bits of the save: nothing of the step leaked
    into the checkpoint."""
    for r in resumed["spmd"]:
        assert r["moved"] and r["restored"]


def test_params_and_opt_state_save_apart(resumed):
    """The reference's user code: save_state_dict(step.params, ...) and
    (step.opt_state, ...): the parameters, then the optimizer's flat
    names, together the whole step's keys."""
    keys = resumed["spmd"][0]["keys"]
    params = set(resumed["spmd"][0]["shapes"])
    assert set(keys[".params"]) == params
    assert "@step" in keys[".opt"] and not params & set(keys[".opt"])
    assert "model.norm.weight_moment1" in keys[".opt"]
    assert set(keys[""]) == set(keys[".params"]) | set(keys[".opt"])


@pytest.mark.parametrize("where", ["one", "mp2"])
def test_resumed_third_step_matches_the_uninterrupted_reference(resumed,
                                                                 where):
    """Steps 3 and 4 after the load: step 3's loss reads the loaded
    parameters, step 4's also the slots, masters and ``@step`` that step
    3's update read."""
    np.testing.assert_allclose(resumed[where], resumed["ref"][2:],
                               rtol=1e-5)


def test_checkpoint_records_the_plan_boxes(resumed):
    meta, shapes = resumed["meta"], resumed["spmd"][0]["shapes"]
    assert meta["world_size"] == 2
    q = meta["tensors"]["model.layers.0.self_attn.q_proj.weight"]
    assert q["sharding"] == {"mesh_shape": [2], "mesh_axes": ["fsdp"],
                             "spec": ["fsdp"]}
    assert sorted(map(str, (s["box"] for s in q["shards"]))) == [
        "[[0, 16], [0, 32]]", "[[16, 32], [0, 32]]"]
    # the uneven cut: 65 rows do not split over fsdp2, so one whole box
    emb = meta["tensors"]["model.embed_tokens.weight"]
    assert shapes["model.embed_tokens.weight"] == (65, 32)
    assert [s["box"] for s in emb["shards"]] == [[[0, 65], [0, 32]]]
    assert emb["sharding"]["spec"] == []
    # slots shard like their parameter; masters absent in f32
    assert len(meta["tensors"][
        "model.layers.0.self_attn.q_proj.weight_moment1"]["shards"]) == 2
    assert resumed["step_at_load"] == 2 and resumed["mp2_count"] == 4


def test_one_rank_step_round_trips_its_scheduler_and_step_count(tmp_path):
    """A sharded step over one rank: the scheduler's numbers and ``@step``
    go through the checkpoint with the slots (0-d records)."""
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    model = W.port_llama({k: v for k, v in _jax_state()[1].items()},
                         "float32", W.CKPT_CFG)
    sched = pt.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=1,
                                      gamma=0.5)
    step = ShardedTrainStep(
        model, pt.AdamW(learning_rate=sched,
                        parameters=model.named_parameters()),
        lambda m, i, l: m(i, labels=l),
        mesh=ProcessMesh(shape=[1], dim_names=["dp"]), rules=[(".*", ())])
    ids, labels = (torch.from_numpy(a) for a in _batch())
    step(ids, labels)
    sched.step()
    ck = str(tmp_path / "one")
    tckpt.save_state_dict(step.state_dict(), ck)
    meta = tckpt.get_checkpoint_metadata(ck)
    assert meta["tensors"]["LR_Scheduler.last_epoch"]["shape"] == []
    before = {k: v.clone() for k, v in step.state_dict().items()}
    step(ids, labels)
    sched.step()
    tckpt.load_state_dict(step.state_dict(), ck)
    assert sched.last_epoch == 1 and sched.last_lr == 5e-4
    assert step.optimizer._step_count == 1
    for k, v in step.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_optimizer_checkpoint_state_round_trips_in_place(tmp_path):
    """A one-process optimizer: ``checkpoint_state()`` holds the live
    slots under the names a sharded step's ``opt_state`` writes, and a
    load fills them in place and sets ``@step`` and the scheduler."""
    p = torch.nn.Parameter(torch.from_numpy(
        np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)))
    sched = pt.optimizer.lr.StepDecay(learning_rate=1e-2, step_size=1,
                                      gamma=0.5)
    opt = pt.AdamW(learning_rate=sched, parameters=[("w", p)])
    for _ in range(2):
        p.grad = p.detach() * 0.5 + 1.0
        opt.step()
        sched.step()
    sd = opt.checkpoint_state()
    assert {"w_moment1", "w_moment2", "@step",
            "LR_Scheduler.last_epoch"} <= set(sd)
    ck = str(tmp_path / "opt")
    tckpt.save_state_dict(sd, ck)
    saved = {k: v.clone() for k, v in sd.items()}
    p.grad = torch.ones_like(p)
    opt.step()
    sched.step()
    live = opt._slots["w"]["moment1"]
    tckpt.load_state_dict(opt.checkpoint_state(), ck)
    assert opt._slots["w"]["moment1"] is live
    for k, v in opt.checkpoint_state().items():
        assert torch.equal(v, saved[k]), k
    assert opt._step_count == 2 and sched.last_epoch == 2
