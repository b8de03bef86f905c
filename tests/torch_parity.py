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

from repro.configs import reduced_config as jax_reduced_config
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch.configs import reduced_config
from repro_torch.weights import params_from_jax

# rtol/atol for f32 comparisons: torch and XLA sum in different orders
F32_TOL = dict(rtol=1e-5, atol=1e-5)

# reduced qwen3-4b (qk-norm, untied), reduced qwen2-0.5b (QKV bias, tied),
# and qwen2-0.5b's own GQA ratio of 7 (not a power of two)
ARCHS = ["qwen3-4b", "qwen2-0.5b", "qwen2-0.5b-rep7"]


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
