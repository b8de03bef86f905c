"""Port model functions vs the JAX reference on the CPU, same inputs.

Every comparison is f32 at ``F32_TOL`` (torch and XLA reduce in different
orders, so bit equality is not expected across frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mlp as TM
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_jax
from torch_parity import ARCHS, F32_TOL, configs, np_of, params


def _close(a, b):
    np.testing.assert_allclose(np_of(a), np_of(b), **F32_TOL)


def test_rmsnorm_and_layernorm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    _close(TC.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JC.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    _close(TC.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias)),
           JC.layernorm(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    """Half-split rotation at positions up to a full-width cache."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 1024, size=(2, 6)).astype(np.int32)
    _close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    jcfg, tcfg = configs("qwen3-4b")
    jcfg = dataclasses.replace(jcfg, act=act)
    tcfg = dataclasses.replace(tcfg, act=act)
    rng = np.random.default_rng(2)
    p = {k: rng.normal(0, 0.1, size=v.shape).astype(np.float32)
         for k, v in JM.init_mlp(jax.random.PRNGKey(0), jcfg).items()}
    x = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    _close(TM.mlp_block({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg),
           JM.mlp_block({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jcfg))


# (sq, sk, causal, chunk, q_offset, kv_len) — kv_len "vec" is per row
ATTN_CASES = {
    "q_blocked_causal": (32, 32, True, 4, 0, None),
    "causal_ragged_chunks": (13, 13, True, 4, 0, None),
    "noncausal_kv_len": (5, 20, False, 8, 0, 11),
    "causal_offset": (4, 12, True, 8, 8, None),
    "single_query_vec_len": (1, 24, False, 8, 0, "vec"),
    "single_query_causal": (1, 24, True, 8, 9, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_reference(case):
    sq, sk, causal, chunk, q_off, kv_len = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    b, h, kvh, hd = 3, 4, 2, 32
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    if kv_len == "vec":
        lens = np.array([1, sk, 7], np.int32)
        tl, jl = torch.from_numpy(lens), jnp.asarray(lens)
    else:
        tl = jl = kv_len
    got = TA.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               chunk=chunk, q_offset=q_off, kv_len=tl)
    want = jax.jit(lambda q_, k_, v_, n_: JA.chunked_attention(
        q_, k_, v_, causal=causal, chunk=chunk, q_offset=q_off, kv_len=n_))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl)
    _close(got, want)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (2, 9), 4)
    got, _ = TT.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    want, _ = jax.jit(lambda p, t: JT.lm_forward(p, jcfg, tokens=t))(
        jp, jnp.asarray(toks))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_step_match_reference(arch):
    """Scalar serving path: prefill, then three decode steps, logits and
    the whole KV cache compared after each."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (2, 7), 5)
    cache_len = 16
    tl, tc = TT.lm_prefill(tp, tcfg, tokens=torch.from_numpy(toks),
                           cache_len=cache_len)
    jl, jc = jax.jit(lambda p, t: JT.lm_prefill(
        p, jcfg, tokens=t, cache_len=cache_len))(jp, jnp.asarray(toks))
    _close(tl, jl)
    j_decode = jax.jit(lambda p, c, t: JT.lm_decode_step(p, c, t, jcfg))
    for step in range(3):
        nxt = _tokens(jcfg, (2, 1), 10 + step)
        tl, tc = TT.lm_decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt))
        _close(tl, jl)
        assert tc["len"] == int(jc["len"])
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_slotted_prefill_and_decode_match_reference(arch):
    """Engine path: right-padded bucket prefill, then slotted decode with
    mixed per-slot lengths and one inactive slot."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (3, 8), 6)
    lens = np.array([8, 3, 5], np.int32)
    cache_len = 12        # slot 0 reaches the end: writes clamp to its tail
    tl, tc = TT.lm_prefill_slotted(tp, tcfg, tokens=torch.from_numpy(toks),
                                   lens=torch.from_numpy(lens),
                                   cache_len=cache_len)
    jl, jc = jax.jit(lambda p, t, n: JT.lm_prefill_slotted(
        p, jcfg, tokens=t, lens=n, cache_len=cache_len))(
            jp, jnp.asarray(toks), jnp.asarray(lens))
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    active = np.array([True, True, False])
    j_decode = jax.jit(lambda p, c, t, a: JT.lm_decode_step_slotted(
        p, c, t, a, jcfg))
    for step in range(5):
        nxt = _tokens(jcfg, (3, 1), 20 + step)
        tl, tc = TT.lm_decode_step_slotted(
            tp, tc, torch.from_numpy(nxt), torch.from_numpy(active), tcfg)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt), jnp.asarray(active))
        _close(tl[active], np.asarray(jl)[active])
        np.testing.assert_array_equal(np_of(tc["lens"]), np_of(jc["lens"]))
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_init_lm_shapes_and_distribution():
    """The port draws its own weights (torch.Generator): same tree, shapes
    and dtypes as the reference, and truncation at +-2 sigma."""
    jcfg, tcfg = configs("qwen3-4b")
    ref = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    got = TT.init_lm(0, tcfg, device="cpu")
    assert len(got["layers"]) == jcfg.n_layers
    for name, leaf in got["layers"][0]["attn"].items():
        assert tuple(leaf.shape) == ref["layers"]["attn"][name].shape[1:]
    assert tuple(got["embed"].shape) == ref["embed"].shape
    w = got["layers"][0]["mlp"]["gate"]
    std = 1.0 / np.sqrt(jcfg.d_model)
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.05   # std of N trunc at 2σ
    again = TT.init_lm(0, tcfg, device="cpu")
    assert torch.equal(again["embed"], got["embed"])  # seeded


def test_params_from_jax_keeps_bf16_bits():
    """Full configs are bf16: the reference's ml_dtypes leaves arrive as
    torch bf16 with the same bits, per layer off the stacked axis."""
    jcfg, _ = configs("qwen2-0.5b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(1), jcfg))
    got = params_from_jax(tree, "cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert np.array_equal(got["embed"].view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))
    q = tree["layers"]["attn"]["q"]
    for i, lp in enumerate(got["layers"]):
        assert np.array_equal(lp["attn"]["q"].view(torch.int16).numpy(),
                              q[i].view(np.int16))
    assert "unembed" not in got                    # tied embeddings
