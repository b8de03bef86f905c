"""The port's SSM and hybrid families vs the JAX reference on the CPU.

Reduced zamba2-7b (Mamba-2 groups around a shared attention block, a tail
layer) and reduced mamba2-780m (Mamba-2 layers only), with the reference's
own initial params carried over by ``params_from_jax``: the forward, and
prefill and decode in the scalar, slotted and paged forms, logits and
every cache leaf, at f32 ``F32_TOL`` (torch and XLA reduce in different
orders).  The port's own random init is held to the reference's shapes,
dtypes and distributions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hybrid as JH
from repro_torch.models import hybrid as TH
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    F32_TOL,
    HYBRID_ARCHS,
    hybrid_configs,
    hybrid_params,
    np_of,
    one_thread,
)

CACHE_LEN = 48


def _model(arch):
    jcfg, tcfg = hybrid_configs(arch)
    jp, tp = hybrid_params(jcfg)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np_of(a), np_of(b), **F32_TOL)


def _close_caches(got, want):
    assert set(got) == set(want)
    for key in want:
        if key == "len":
            assert got[key] == int(want[key])
        else:
            assert tuple(got[key].shape) == want[key].shape, key
            _close(got[key], want[key])


def _copy(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg, (2, 37), 0)        # ragged: 37 = 2 chunks + 5
    got, aux = TH.hybrid_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    want, _ = jax.jit(lambda p, t: JH.hybrid_forward(p, jcfg, tokens=t))(
        jp, jnp.asarray(toks))
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """Scalar serving path: prefill, then three decode steps; logits and
    every cache leaf compared after each."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg, (2, 21), 1)
    jprefill = jax.jit(lambda p, t: JH.hybrid_prefill(
        p, jcfg, tokens=t, cache_len=CACHE_LEN))
    jdecode = jax.jit(lambda p, c, t: JH.hybrid_decode_step(p, c, t, jcfg))
    logits, cache = TH.hybrid_prefill(tp, tcfg, tokens=torch.from_numpy(toks),
                                      cache_len=CACHE_LEN)
    jlogits, jcache = jprefill(jp, jnp.asarray(toks))
    _close(logits, jlogits)
    _close_caches(cache, jcache)
    for step in range(3):
        nxt = _tokens(jcfg, (2, 1), 10 + step)
        logits, cache = TH.hybrid_decode_step(tp, cache,
                                              torch.from_numpy(nxt), tcfg)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(nxt))
        _close(logits, jlogits)
        _close_caches(cache, jcache)


def _random_states(cfg, cache, rng):
    """Per-row conv/SSM states and K/V drawn from ``rng`` (numpy), written
    into ``cache``'s leaves of the same names: a mid-run cache."""
    out = dict(cache)
    for key in ("conv", "ssm", "conv_tail", "ssm_tail", "k", "v"):
        if key in cache:
            out[key] = rng.normal(0, 0.5, np.shape(cache[key])).astype(
                np.float32)
    return out


def _both(cache_np):
    """(port cache, jax cache) of one numpy cache."""
    return ({k: torch.from_numpy(np.array(v)) for k, v in cache_np.items()},
            {k: jnp.asarray(v) for k, v in cache_np.items()})


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_slotted_prefill_and_decode_match_reference(arch):
    """Exact-length bucket prefill, then decode steps over slots at their
    own lengths with one slot inactive (its length must not advance)."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg, (2, 13), 2)
    lens = np.full((2,), 13, np.int32)
    logits, cache = TH.hybrid_prefill_slotted(
        tp, tcfg, tokens=torch.from_numpy(toks), lens=torch.from_numpy(lens),
        cache_len=CACHE_LEN)
    jlogits, jcache = jax.jit(lambda p, t, n: JH.hybrid_prefill_slotted(
        p, jcfg, tokens=t, lens=n, cache_len=CACHE_LEN))(
            jp, jnp.asarray(toks), jnp.asarray(lens))
    _close(logits, jlogits)
    _close_caches(cache, jcache)

    rng = np.random.default_rng(3)
    state = {k: np.asarray(v) for k, v in jax.tree.map(
        np.asarray, JH.init_hybrid_slot_cache(jcfg, 3, CACHE_LEN)).items()}
    state = _random_states(jcfg, state, rng)
    state["lens"] = np.array([5, 30, 11], np.int32)
    cache, jcache = _both(state)
    active = np.array([True, False, True])
    jdecode = jax.jit(lambda p, c, t, a: JH.hybrid_decode_step_slotted(
        p, c, t, a, jcfg))
    for step in range(3):
        nxt = _tokens(jcfg, (3, 1), 20 + step)
        logits, cache = TH.hybrid_decode_step_slotted(
            tp, cache, torch.from_numpy(nxt), torch.from_numpy(active), tcfg)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(nxt),
                                  jnp.asarray(active))
        _close(logits, jlogits)
        _close_caches(cache, jcache)
    assert cache["lens"].tolist() == [8, 30, 14]


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_paged_prefill_and_decode_match_reference(arch):
    """Unpadded prefill rows, then decode steps against shuffled pool
    blocks (sentinel entries past each row's length, one slot inactive):
    logits, every per-slot state and every pool block, which the inactive
    slot must leave untouched."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg, (2, 11), 4)
    lens = np.full((2,), 11, np.int32)
    logits, rows = TH.hybrid_prefill_paged(
        tp, tcfg, tokens=torch.from_numpy(toks), lens=torch.from_numpy(lens))
    jlogits, jrows = jax.jit(lambda p, t, n: JH.hybrid_prefill_paged(
        p, jcfg, tokens=t, lens=n))(jp, jnp.asarray(toks), jnp.asarray(lens))
    _close(logits, jlogits)
    _close_caches(rows, jrows)

    slots, bs, n_blocks = 3, 8, 20
    rng = np.random.default_rng(5)
    state = jax.tree.map(np.asarray, JH.init_hybrid_paged_cache(
        jcfg, slots, CACHE_LEN, n_blocks, bs))
    state = _random_states(jcfg, state, rng)
    state["lens"] = np.array([5, 30, 16], np.int32)
    perm = rng.permutation(n_blocks)
    tables = np.full((slots, CACHE_LEN // bs), n_blocks, np.int32)
    for s, n in enumerate([1, 4, 3]):      # blocks covering lens + 1
        tables[s, :n] = perm[6 * s: 6 * s + n]
    state["tables"] = tables
    cache, jcache = _both(state)
    active = np.array([True, False, True])
    jdecode = jax.jit(lambda p, c, t, a: JH.hybrid_decode_step_paged(
        p, c, t, a, jcfg))
    for step in range(2):
        nxt = _tokens(jcfg, (slots, 1), 30 + step)
        logits, cache = TH.hybrid_decode_step_paged(
            tp, cache, torch.from_numpy(nxt), torch.from_numpy(active), tcfg)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(nxt),
                                  jnp.asarray(active))
        _close(logits, jlogits)
        _close_caches(cache, jcache)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a port param tree (dicts and lists)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_random_init_has_reference_shapes_and_distributions(arch):
    """Same tree, shapes and dtypes as the reference's ``init_hybrid``
    (mapped through ``params_from_jax``); each leaf's distribution: dt_bias
    the inverse softplus of dt in [1e-3, 0.1], A_log in [0, log 16],
    conv_w within +-1/sqrt(K C), D = 1, zero conv bias, unit norm scales,
    and the truncated-normal matrices at the reference's spread (std
    within 5%, both cut at two standard deviations)."""
    jcfg, tcfg = hybrid_configs(arch)
    ref_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: JH.init_hybrid(k, jcfg))(jax.random.PRNGKey(0)))
    from repro_torch.weights import params_from_jax
    ref = params_from_jax(ref_tree, "cpu")
    got = TH.init_hybrid(0, tcfg, device="cpu")
    ref_leaves, got_leaves = dict(_leaves(ref)), dict(_leaves(got))
    assert sorted(got_leaves, key=str) == sorted(ref_leaves, key=str)
    by_name = {}
    for path, a in got_leaves.items():
        b = ref_leaves[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        by_name.setdefault(path[-1], []).append((a.flatten(), b.flatten()))
    k_c = tcfg.conv_kernel * (tcfg.d_inner
                              + 2 * tcfg.ssm_groups * tcfg.ssm_state)
    for name, pairs in by_name.items():
        a = torch.cat([x for x, _ in pairs])
        b = torch.cat([y for _, y in pairs])
        if name == "dt_bias":
            dt = torch.nn.functional.softplus(a)
            assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
        elif name == "A_log":
            assert a.min() >= 0 and a.max() <= np.log(16.0) + 1e-6
        elif name == "conv_w":
            assert a.abs().max() <= 1.0 / np.sqrt(k_c)
            assert a.std() == pytest.approx(float(b.std()), rel=0.05)
        elif name in ("D", "scale", "norm_scale", "q_norm", "k_norm"):
            assert torch.equal(a, torch.ones_like(a))
        elif name in ("conv_b", "q_b", "k_b", "v_b"):
            assert torch.equal(a, torch.zeros_like(a))
        else:                       # truncated-normal matrices
            assert a.std() == pytest.approx(float(b.std()), rel=0.05), name
            assert a.abs().max() <= 2.0 * a.std() / 0.88 * 1.01
            assert abs(float(a.mean())) < 0.05 * float(a.std()) + 1e-3
