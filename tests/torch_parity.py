"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Reference params come from ``repro``'s own ``init_lm`` and are copied into
the port with ``params_from_jax``: JAX's threefry init cannot be replayed
in torch.  Biases and norm scales are perturbed with a numpy stream first,
because the reference initialises them to exactly 0 and 1, which would
leave the QKV-bias and norm arithmetic untested.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch.configs import reduced_config
from repro_torch.weights import params_from_jax

# rtol/atol for f32 comparisons: torch and XLA sum in different orders
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a module's tests, restored after it.  The
    tests run many small ops, in several worker processes at once; with a
    thread pool per core in every worker they oversubscribe the cores, and
    six concurrent runs of tests/test_torch_chip_smoke_hybrid.py took over
    900 s against 24 s with one thread each.  A module imports this
    fixture to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# reduced qwen3-4b (qk-norm, untied), reduced qwen2-0.5b (QKV bias, tied),
# and qwen2-0.5b's own GQA ratio of 7 (not a power of two)
ARCHS = ["qwen3-4b", "qwen2-0.5b", "qwen2-0.5b-rep7"]
# reduced dbrx-132b (8 experts, top-2) and reduced kimi-k2 (the same, plus
# a shared expert); ``configs`` and ``params`` serve them as they do ARCHS
MOE_ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]


def configs(arch):
    """(repro config, port config) for one of :data:`ARCHS`."""
    base = arch.replace("-rep7", "")
    jcfg, tcfg = jax_reduced_config(base), reduced_config(base)
    if arch.endswith("-rep7"):
        change = dict(n_heads=14, n_kv_heads=2, head_dim=32)
        jcfg = dataclasses.replace(jcfg, **change)
        tcfg = dataclasses.replace(tcfg, **change)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def params(jcfg, seed=0):
    """(jax params, port params on the CPU) holding the same numbers.
    Cached per config: neither package writes to its params."""
    init = jax.jit(lambda key: jax_init_lm(key, jcfg))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name in ("q_b", "k_b", "v_b"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        if name in ("scale", "q_norm", "k_norm"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def np_of(x):
    """numpy view of a torch tensor or jax array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


# ---------------------------------------------------------------- ECG path

# The full-width genome of chip_smoke.py's phase 9: dw7s1c32, dw7s1c32,
# dw5s2c32, dw5s2c32, mp4, dw3s1c32, dw3s2c32 (+ gap, fc2), w8a16i16, input
# (3750, 2).  Op ids index the search space's op table (60 convs, c-major,
# then 4 pools); node i reads node i - 1.
WIDE_GENES = dict(op_genes=(57, 57, 55, 55, 61, 51, 52) + (0,) * 8,
                  conn_genes=tuple(range(15)), out_gene=7, w_bits_gene=1,
                  a_bits_gene=1, i_bits_gene=1, dec_gene=0)
# A narrow one for the CPU tests: dw5s2c8, mp4, dw3s1c16, dw7s4c4 (+ gap,
# fc2), w4a8i16, input (1875, 2).
NARROW_GENES = dict(op_genes=(31, 61, 39, 23) + (0,) * 11,
                    conn_genes=tuple(range(15)), out_gene=4, w_bits_gene=0,
                    a_bits_gene=0, i_bits_gene=1, dec_gene=1)


def genomes(genes):
    """(repro Genome, port Genome) of the same genes."""
    from repro.core.genome import Genome as JaxGenome
    from repro_torch.core.genome import Genome
    return JaxGenome(**genes), Genome(**genes)


def candidate_params(jspecs, seed=0, perturb=True):
    """(jax params, numpy params) of ``repro``'s ``init_candidate``.  With
    ``perturb`` the conv biases and BN params are moved off the init's
    exact 0 and 1 (with a numpy stream), so that BN and bias arithmetic is
    exercised."""
    from repro.core.trainer import init_candidate
    tree = jax.tree.map(np.asarray,
                        init_candidate(jax.random.PRNGKey(seed), jspecs))
    rng = np.random.default_rng(seed)
    if perturb:
        for p in tree:
            for k in ("b", "bn_mean", "bn_bias", "bn_scale"):
                if k in p:
                    p[k] = (p[k] + rng.normal(0, 0.1, p[k].shape)
                            ).astype(np.float32)
            if "bn_var" in p:
                p["bn_var"] = rng.uniform(0.5, 2.0, p["bn_var"].shape
                                          ).astype(np.float32)
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in tree], tree


# ------------------------------------------------------ SSM / hybrid path

HYBRID_ARCHS = ["zamba2-7b", "mamba2-780m"]


def hybrid_configs(arch):
    """(repro config, port config): the reduced zamba2-7b (13 layers, two
    groups of 6 around the shared block, one tail layer) or mamba2-780m
    (3 tail layers, no shared block)."""
    return jax_reduced_config(arch), reduced_config(arch)


@functools.lru_cache(maxsize=None)
def hybrid_params(jcfg, seed=0):
    """(jax params, port params on the CPU) of ``repro``'s ``init_hybrid``,
    with norm scales, D, the conv bias and dt_bias moved off their init
    values (exactly 1, 1, 0 and a fixed curve) by a numpy stream."""
    from repro.models.hybrid import init_hybrid
    init = jax.jit(lambda key: init_hybrid(key, jcfg))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if path[-1].key in ("scale", "norm_scale", "D", "conv_b", "dt_bias",
                            "q_norm", "k_norm"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")
