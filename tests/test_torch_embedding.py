"""The port's embedding lookup and its deterministic backward vs the
reference (CPU).

``repro_torch.models.transformer.embed_tokens`` is a lookup whose backward
(``embedding_grad``) sums each table row's contributions in an order fixed
by the ids alone, in f32, rounded once to the table's dtype, so that a
training step repeats bit for bit on the card.  Held here against
``jax.grad`` of ``repro``'s ``embed_tokens`` (``jnp.take``) on the same
numbers, with heavily repeated ids.

Tolerances: f32 gradients within 1e-5 relative to the largest row sum
(both sides sum in f32, in different orders, up to 1,500 terms a row);
a bf16 table's gradient within one bf16 rounding (2^-8 relative) of the
f64 sum, since the port rounds its f32 sum once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.transformer import embed_tokens as jax_embed_tokens
from repro_torch.configs import reduced_config
from repro_torch.models.transformer import embed_tokens, embedding_grad
from torch_parity import np_of, one_thread  # noqa: F401 (a fixture)

VOCAB, WIDTH = 97, 24


def _cfgs(dtype):
    change = dict(vocab_size=VOCAB, d_model=WIDTH, dtype=dtype)
    return (dataclasses.replace(jax_reduced_config("qwen2-0.5b"), **change),
            dataclasses.replace(reduced_config("qwen2-0.5b"), **change))


def _tokens(kind, shape, seed):
    """Token ids of one of three kinds: uniform over the vocab; a few ids
    repeated hundreds of times; one id everywhere but a handful."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, VOCAB, shape)
    if kind == "repeated":
        return rng.choice([3, 5, 96], size=shape, p=[0.6, 0.3, 0.1])
    ids = np.full(shape, 7)
    few = min(5, ids.size - 1)
    ids.flat[rng.choice(ids.size, few, replace=False)] = rng.integers(
        0, VOCAB, few)
    return ids


KINDS = ["uniform", "repeated", "one_id"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(1, 1), (4, 37), (3, 500)],
                         ids=["one", "small", "wide"])
def test_lookup_and_grad_match_jax(kind, shape):
    """Forward values equal ``jnp.take``'s; the table's gradient equals
    ``jax.grad`` of the reference's lookup under a random cotangent."""
    jcfg, tcfg = _cfgs("float32")
    rng = np.random.default_rng(1)
    table = rng.normal(size=(VOCAB, WIDTH)).astype(np.float32)
    ids = _tokens(kind, shape, seed=2)
    cot = rng.normal(size=shape + (WIDTH,)).astype(np.float32)

    def jax_loss(t):
        return jnp.sum(jax_embed_tokens({"embed": t}, jnp.asarray(ids),
                                        jcfg) * cot)
    want_out = jax_embed_tokens({"embed": jnp.asarray(table)},
                                jnp.asarray(ids), jcfg)
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))

    t = torch.from_numpy(table).requires_grad_(True)
    out = embed_tokens({"embed": t}, torch.from_numpy(ids), tcfg)
    np.testing.assert_array_equal(np_of(out.detach()), np.asarray(want_out))
    out.backward(torch.from_numpy(cot))
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np_of(t.grad), want, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_grad_is_the_sum_rounded_once(kind):
    """A bf16 table: each row's gradient is the exact sum of its rows of
    the cotangent rounded once to bf16, within that one rounding."""
    ids = torch.from_numpy(_tokens(kind, (2048,), seed=3))
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2048, WIDTH)).astype(np.float32)).to(torch.bfloat16)
    got = embedding_grad(ids, g, VOCAB, torch.bfloat16)
    exact = torch.zeros(VOCAB, WIDTH, dtype=torch.float64).index_add_(
        0, ids, g.double())
    assert got.dtype == torch.bfloat16
    err = (got.double() - exact).abs()
    assert bool((err <= 2.0 ** -8 * exact.abs() + 1e-30).all())
    untouched = torch.ones(VOCAB, dtype=torch.bool)
    untouched[ids] = False
    assert not got[untouched].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_repeats_bit_for_bit(kind, dtype):
    """Two backward calls on the same ids and cotangent are equal bit for
    bit, through autograd and called directly."""
    _, tcfg = _cfgs("float32")
    ids = torch.from_numpy(_tokens(kind, (8, 64), seed=5))
    cot = torch.from_numpy(np.random.default_rng(6).normal(
        size=(8, 64, WIDTH)).astype(np.float32))
    grads = []
    for _ in range(2):
        t = torch.zeros(VOCAB, WIDTH, dtype=dtype, requires_grad=True)
        embed_tokens({"embed": t}, ids, tcfg).backward(cot)
        grads.append(t.grad)
    assert grads[0].dtype == dtype
    assert torch.equal(grads[0], grads[1])
    # the lookup's output is cast to the config's f32, so its gradient
    # reaches the backward in the table's dtype
    flat = cot.reshape(-1, WIDTH).to(dtype)
    assert torch.equal(embedding_grad(ids.reshape(-1), flat, VOCAB, dtype),
                       grads[0])


def test_grad_of_no_ids_is_zero():
    got = embedding_grad(torch.zeros(0, dtype=torch.int64),
                         torch.zeros(0, WIDTH), VOCAB, torch.float32)
    assert got.shape == (VOCAB, WIDTH) and not got.any()
