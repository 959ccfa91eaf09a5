"""The distributed checkpoint with CUDA tensors (``cuda`` marker; skipped
without CUDA). No JAX here: ``python -m pytest
tests/test_torch_checkpoint_card.py -m cuda --noconftest``.

* **The async save against in-place updates.** An async save of CUDA
  tensors, then at once a long queue of in-place updates to them on the
  current stream (what an optimizer's step does), then the wait: the
  checkpoint holds the state at the call, bit for bit, never a mix of two
  steps; the same with one Llama train step (a ``TrainStep`` over a small
  f32 Llama, its parameters, slots and step count) between the save and
  the wait, the loaded state equal to the pre-step one.
* **No copy on the card.** An async save's snapshot goes to page-locked
  host memory: the device's peak does not move over the call and the
  wait; bf16, bool, int64, 0-d and non-contiguous CUDA values come back
  bit for bit, and a second async save after the first's wait does too,
  through the buffer the first one locked.
* **bf16 on the card**: a bf16 CUDA tensor writes the CPU tensor's bytes
  (descr ``'<V2'``), loads back into a CUDA bf16 target bit for bit and
  into an f32 one as its exact widening; a load keeps each target's
  device.
* **Reshard to whole on the card**: two simulated ranks' row and column
  halves loaded into whole CUDA targets, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _ckpt():
    from paddlepaddle_tpu_torch.distributed import checkpoint

    return checkpoint


def test_async_save_holds_the_state_at_the_call(tmp_path):
    _card()
    ck = _ckpt()
    g = torch.Generator(device="cuda").manual_seed(0)
    # large enough that the writer is still copying when the updates run
    sd = {f"t{i}": torch.randn(4096, 4096, device="cuda", generator=g)
          for i in range(6)}
    want = {k: v.cpu() for k, v in sd.items()}
    ck.save_state_dict(sd, str(tmp_path / "a"), async_save=True)
    for _ in range(20):                       # in-place updates at once
        for v in sd.values():
            v.mul_(1.5).add_(1.0)
    ck.wait_all_saves()
    out = {k: torch.zeros_like(v) for k, v in sd.items()}
    ck.load_state_dict(out, str(tmp_path / "a"))
    for k in sd:
        assert out[k].is_cuda
        assert torch.equal(out[k].cpu(), want[k]), k


def test_a_train_step_between_save_and_wait_does_not_leak(tmp_path):
    _card()
    import paddlepaddle_tpu_torch as pt

    ck = _ckpt()
    cfg = pt.LlamaConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256, dtype="float32")
    model = pt.LlamaForCausalLM(cfg, seed=0)
    opt = pt.AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    step = pt.TrainStep(model, opt, lambda m, i, l: m(i, labels=l))
    ids = torch.randint(0, 512, (2, 128), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    step(ids, ids)

    def state():
        out = {f"p/{n}": p for n, p in model.named_parameters()}
        for n, slots in opt._slots.items():
            out.update({f"s/{n}/{k}": v for k, v in slots.items()})
        return out

    before = {k: v.detach().cpu().clone() for k, v in state().items()}
    ck.save_state_dict(state(), str(tmp_path / "s"), async_save=True)
    step(ids, ids)                            # in place, beside the write
    ck.wait_all_saves()
    moved = any(not torch.equal(v.detach().cpu(), before[k])
                for k, v in state().items())
    assert moved                              # the step did update them
    ck.load_state_dict(state(), str(tmp_path / "s"))
    for k, v in state().items():
        assert torch.equal(v.detach().cpu(), before[k]), k


def test_async_save_keeps_no_copy_on_the_card(tmp_path):
    _card()
    ck = _ckpt()
    g = torch.Generator(device="cuda").manual_seed(2)
    base = torch.randn(2048, 1536, device="cuda", generator=g)
    sd = {"f32": base, "bf16": base.bfloat16(),
          "t": base[:1024, :512].t(),              # non-contiguous
          "i64": torch.randint(-9, 9, (333,), device="cuda", generator=g),
          "mask": base[:7, :5] > 0, "n": torch.tensor(17, device="cuda")}
    want = {k: v.cpu() for k, v in sd.items()}
    ck.release_snapshot_buffers()
    kept = []
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ck.save_state_dict(sd, str(tmp_path / f"n{i}"), async_save=True)
        called = torch.cuda.max_memory_allocated() - held
        ck.wait_all_saves()
        waited = torch.cuda.max_memory_allocated() - held
        # the transposed view is made contiguous on the card for its copy
        assert called <= 4 << 20 and waited <= 4 << 20, (called, waited)
        out = {k: torch.zeros_like(v).contiguous() for k, v in sd.items()}
        ck.load_state_dict(out, str(tmp_path / f"n{i}"))
        for k in sd:
            assert out[k].is_cuda and torch.equal(out[k].cpu(), want[k]), k
        kept.append([b.data_ptr() for b in ck._free_locked])
    # the second save wrote through the buffer the first one locked
    assert len(kept[0]) == 1 and kept[1] == kept[0]
    ck.release_snapshot_buffers()
    assert not ck._free_locked


def test_bf16_on_the_card_round_trips(tmp_path):
    _card()
    ck = _ckpt()
    x = torch.randn(257, 129, generator=torch.Generator().manual_seed(3))
    ck.save_state_dict({"w": x.bfloat16().cuda()}, str(tmp_path / "card"))
    ck.save_state_dict({"w": x.bfloat16()}, str(tmp_path / "host"))
    a = open(os.path.join(tmp_path, "card", "w.npy"), "rb").read()
    b = open(os.path.join(tmp_path, "host", "w.npy"), "rb").read()
    assert a == b and b"'<V2'" in a[:128]
    out = {"w": torch.zeros(257, 129, dtype=torch.bfloat16, device="cuda")}
    ck.load_state_dict(out, str(tmp_path / "card"))
    assert out["w"].is_cuda
    assert torch.equal(out["w"].cpu(), x.bfloat16())
    wide = {"w": torch.zeros(257, 129, device="cuda")}
    ck.load_state_dict(wide, str(tmp_path / "card"))
    assert torch.equal(wide["w"].cpu(), x.bfloat16().float())
    words = np.load(os.path.join(tmp_path, "card", "w.npy"))
    np.testing.assert_array_equal(words.view(np.int16),
                                  x.bfloat16().view(torch.int16).numpy())


def test_reshard_to_whole_on_the_card(tmp_path):
    """Two simulated ranks' blocks (row halves of one tensor, column
    halves of another) loaded into whole CUDA targets: a row half is read
    straight into its view of the target, a column half through its
    map."""
    _card()
    ck = _ckpt()
    g = torch.Generator().manual_seed(4)
    a = torch.randn(64, 48, generator=g)
    b = torch.randn(48, 64, generator=g).bfloat16()
    path = str(tmp_path / "two")
    for r in (1, 0):
        ck.save_state_dict(
            {"a": ck.LocalShards((64, 48), "float32", [
                ([[32 * r, 32 * r + 32], [0, 48]], a[32 * r:32 * r + 32]
                 .cuda())]),
             "b": ck.LocalShards((48, 64), "bfloat16", [
                 ([[0, 48], [32 * r, 32 * r + 32]],
                  b[:, 32 * r:32 * r + 32].contiguous().cuda())])},
            path, process_index=r, process_count=2)
    whole = {"a": torch.zeros(64, 48, device="cuda"),
             "b": torch.zeros(48, 64, dtype=torch.bfloat16, device="cuda")}
    ck.load_state_dict(whole, path)
    assert torch.equal(whole["a"].cpu(), a)
    assert torch.equal(whole["b"].cpu(), b)
