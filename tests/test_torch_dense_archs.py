"""granite-34b and mistral-large-123b, the dense configs this slice copies,
at their reduced forms vs the JAX reference on the CPU.

They add no code path: granite-34b is MQA (48 heads over 1 KV head,
reduced to 4 over 1) and mistral-large-123b GQA with rope_theta 1e6
(reduced to 4 over 2), both served by ``models/transformer.py``.  The
scalar prefill and three decode steps, and the engine's right-padded
bucket prefill and slotted decode, are held to ``repro``'s at f32
``F32_TOL``, as tests/test_torch_models.py holds the other dense archs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as TT
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    F32_TOL,
    configs,
    np_of,
    one_thread,
    params,
)

ARCHS = ["granite-34b", "mistral-large-123b"]


def _close(a, b):
    np.testing.assert_allclose(np_of(a), np_of(b), **F32_TOL)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_keeps_the_gqa_class(arch):
    _, tcfg = configs(arch)
    assert (tcfg.n_heads, tcfg.n_kv_heads) == \
        {"granite-34b": (4, 1), "mistral-large-123b": (4, 2)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (2, 7), 5)
    with torch.no_grad():
        tl, tc = TT.lm_prefill(tp, tcfg, tokens=torch.from_numpy(toks),
                               cache_len=16)
    jl, jc = jax.jit(lambda p, t: JT.lm_prefill(
        p, jcfg, tokens=t, cache_len=16))(jp, jnp.asarray(toks))
    _close(tl, jl)
    j_decode = jax.jit(lambda p, c, t: JT.lm_decode_step(p, c, t, jcfg))
    for step in range(3):
        nxt = _tokens(jcfg, (2, 1), 10 + step)
        with torch.no_grad():
            tl, tc = TT.lm_decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt))
        _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_slotted_prefill_and_decode_match_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (3, 8), 6)
    lens = np.array([8, 3, 5], np.int32)
    with torch.no_grad():
        tl, tc = TT.lm_prefill_slotted(
            tp, tcfg, tokens=torch.from_numpy(toks),
            lens=torch.from_numpy(lens), cache_len=12)
    jl, jc = jax.jit(lambda p, t, n: JT.lm_prefill_slotted(
        p, jcfg, tokens=t, lens=n, cache_len=12))(
            jp, jnp.asarray(toks), jnp.asarray(lens))
    _close(tl, jl)
    active = np.array([True, True, False])
    j_decode = jax.jit(lambda p, c, t, a: JT.lm_decode_step_slotted(
        p, c, t, a, jcfg))
    for step in range(4):
        nxt = _tokens(jcfg, (3, 1), 20 + step)
        with torch.no_grad():
            tl, tc = TT.lm_decode_step_slotted(
                tp, tc, torch.from_numpy(nxt), torch.from_numpy(active),
                tcfg)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt), jnp.asarray(active))
        _close(tl[active], np.asarray(jl)[active])
    _close(tc["k"], jc["k"])
