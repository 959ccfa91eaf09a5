"""The port's seeded random streams (paddlepaddle_tpu_torch/core/random.py,
counterpart of paddlepaddle_tpu/core/random.py). The draws cannot be
bit-equal to the JAX key splitting, so these tests hold what carries over:
a seed reproduces the draws, the state round-trips, named generators and
``generator_scope`` route as in the JAX package, and the attention dropouts
follow the port's seed rather than torch's global generator."""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.core import random as prandom
from paddlepaddle_tpu_torch.nn import functional as tF


def _draw(name=None, n=8):
    return torch.rand(n, generator=prandom.torch_generator("cpu", name))


def test_seed_reproduces_draws():
    prandom.seed(3)
    a = torch.cat([_draw(), _draw()])
    prandom.seed(3)
    torch.manual_seed(77)                 # torch's global stream is apart
    b = torch.cat([_draw(), _draw()])
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    prandom.seed(4)
    assert not torch.equal(_draw(), a[:8])
    assert prandom.default_generator().initial_seed() == 4


def test_named_generators_follow_seed():
    """As in the JAX package, ``seed(s)`` gives the i-th named generator the
    seed ``s + i + 1``; the default stream and a named one differ."""
    gen = prandom.get_generator("named_stream")
    prandom.seed(10)
    i = list(prandom._named_generators).index("named_stream")
    assert gen.initial_seed() == 10 + i + 1
    assert prandom.get_generator(None) is prandom.default_generator()
    a = _draw("named_stream")
    assert not torch.equal(a, _draw())
    prandom.seed(10)
    torch.testing.assert_close(_draw("named_stream"), a, atol=0, rtol=0)


def test_rng_state_round_trips():
    prandom.seed(5)
    prandom.get_generator("state_stream")
    _draw()
    state = prandom.get_rng_state()
    want = (_draw(), _draw("state_stream"))
    _draw()
    _draw("state_stream")
    prandom.set_rng_state(state)
    got = (_draw(), _draw("state_stream"))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_generator_scope_routes_unnamed_draws():
    scoped = prandom.Generator(9)
    want = torch.rand(8, generator=prandom.Generator(9).torch_generator())
    prandom.seed(0)
    with prandom.generator_scope(scoped) as g:
        assert g is scoped
        got = _draw()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # outside the scope the default stream is untouched by the scoped draw
    prandom.seed(0)
    torch.testing.assert_close(
        _draw(), torch.rand(8, generator=torch.Generator().manual_seed(0)),
        atol=0, rtol=0)


@pytest.mark.parametrize("entry", ["sdpa", "flash_attention"])
def test_dense_dropout_follows_port_seed(entry):
    """The dense flash dropout (ops/kernels/flash_attention.py) draws its
    mask from the port's stream for the tensor's device: the same port seed
    gives the same mask whatever torch's global seed, another port seed
    another mask."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 32))
                                .astype(np.float32)) for _ in range(3))

    def run():
        if entry == "sdpa":
            return tF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                                   is_causal=True)
        return tF.flash_attention(q, k, v, dropout=0.5, causal=True)[0]

    prandom.seed(21)
    torch.manual_seed(0)
    first = run()
    prandom.seed(21)
    torch.manual_seed(1)
    torch.testing.assert_close(run(), first, atol=0, rtol=0)
    prandom.seed(22)
    torch.manual_seed(0)
    assert not torch.equal(run(), first)
