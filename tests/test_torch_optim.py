"""Port optimizers vs the reference (CPU): AdamW and Adafactor updates
from the same grads, the learning-rate schedules, clipping, and the
reference's own optimizer checks (tests/test_optim_compression.py) on the
port.

Tolerance 1e-6 (rtol and atol): both sides compute each update in f32,
torch and XLA reduce the means in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import schedules as jax_schedules
from repro_torch.optim import (
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    schedules,
)
from repro_torch.optim.adamw import stack_lists, tree_map, unstack_like
from torch_parity import np_of, one_thread  # noqa: F401 (a fixture)

TOL = dict(rtol=1e-6, atol=1e-6)
N_LAYERS = 3


def _trees(seed, dtype=np.float32):
    """(port tree, reference tree) of the same numbers: the port keeps
    three layers as a list, the reference stacks them, as the models do;
    1-, 2- and 3-D leaves."""
    rng = np.random.default_rng(seed)
    layers = [{"w": rng.normal(size=(4, 6)).astype(dtype),
               "b": rng.normal(size=(6,)).astype(dtype)}
              for _ in range(N_LAYERS)]
    embed = rng.normal(size=(10, 4)).astype(dtype)
    experts = rng.normal(size=(2, 3, 5)).astype(dtype)
    port = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in lp.items()}
                       for lp in layers],
            "embed": torch.from_numpy(embed.copy()),
            "experts": torch.from_numpy(experts.copy())}
    ref = {"layers": {k: jnp.asarray(np.stack([lp[k] for lp in layers]))
                      for k in ("w", "b")},
           "embed": jnp.asarray(embed), "experts": jnp.asarray(experts)}
    return port, ref


def _close_trees(port, ref):
    stacked = stack_lists(port)
    for k in ("embed", "experts"):
        np.testing.assert_allclose(np_of(stacked[k]), np.asarray(ref[k]),
                                   **TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(np_of(stacked["layers"][k]),
                                   np.asarray(ref["layers"][k]), **TOL)


OPTIMIZERS = {
    "adamw": (lambda: adamw(3e-2, b1=0.9, b2=0.95, weight_decay=0.1),
              lambda: jax_adamw(3e-2, b1=0.9, b2=0.95, weight_decay=0.1)),
    "adamw_cosine": (
        lambda: adamw(schedules.cosine_schedule(3e-2, 4)),
        lambda: jax_adamw(jax_schedules.cosine_schedule(3e-2, 4))),
    "adafactor": (lambda: adafactor(3e-2, weight_decay=0.1),
                  lambda: jax_adafactor(3e-2, weight_decay=0.1)),
    "adafactor_unclipped": (lambda: adafactor(1e-3, clip_threshold=1e3),
                            lambda: jax_adafactor(1e-3, clip_threshold=1e3)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_updates_match_reference(name):
    """Four updates from the same params and grads: each step's updates,
    the new params and the optimizer state, to 1e-6."""
    make, make_ref = OPTIMIZERS[name]
    params, jparams = _trees(0)
    opt, jopt = make(), make_ref()
    state, jstate = opt.init(params), jopt.init(jparams)
    for step in range(4):
        grads, jgrads = _trees(100 + step)
        updates, state = opt.update(grads, state, params)
        jupdates, jstate = jax.jit(jopt.update)(jgrads, jstate, jparams)
        _close_trees(updates, jupdates)
        params = apply_updates(params, updates)
        jparams = jax_apply_updates(jparams, jupdates)
        _close_trees(params, jparams)
    assert state.step == int(jstate.step) == 4
    for field in state._fields[1:]:
        got, want = getattr(state, field), getattr(jstate, field)
        if name.startswith("adamw"):
            got = stack_lists(got)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            node = got
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(np_of(node), np.asarray(leaf), **TOL)


def test_adafactor_state_keeps_the_stacked_layout():
    """Adafactor factors the reference's stacked leaves: a layer's (D,)
    norm scale stacks to (L, D), which is factored, as in the reference."""
    params, jparams = _trees(0)
    state, jstate = adafactor(1e-2).init(params), \
        jax_adafactor(1e-2).init(jparams)
    for field in ("vr", "vc"):
        got, want = getattr(state, field), getattr(jstate, field)
        assert tuple(got["layers"]["b"].shape) == want["layers"]["b"].shape
        assert tuple(got["layers"]["w"].shape) == want["layers"]["w"].shape
        assert tuple(got["embed"].shape) == want["embed"].shape


def test_stack_lists_round_trip():
    params, _ = _trees(3)
    back = unstack_like(stack_lists(params), params)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             params, back)
    nested = [[{"x": torch.full((2,), float(3 * i + j))} for j in range(3)]
              for i in range(2)]
    assert tuple(stack_lists(nested)["x"].shape) == (2, 3, 2)


SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "cosine": lambda m: m.cosine_schedule(3e-4, 100),
    "cosine_final": lambda m: m.cosine_schedule(1e-3, 37, 0.2),
    "warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, 10, 100),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    """Every step 0-129 in f32, at most one f32 ulp apart: XLA's own f32
    cos is not the same function under jit and eagerly (it differs by an
    ulp at about a third of these steps between the two), and the port
    follows the eager one to within that ulp."""
    got = SCHEDULES[name](schedules)
    want = SCHEDULES[name](jax_schedules)
    steps = range(130)
    g = np.asarray([got(s) for s in steps])
    w = np.asarray([np.asarray(want(jnp.int32(s))) for s in steps])
    assert g.dtype == np.float32
    np.testing.assert_array_max_ulp(g, w, maxulp=1)
    assert (g == w).mean() >= 0.95
    assert g[0] == w[0] and g[-1] == w[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_reference(dtype):
    rng = np.random.default_rng(5)
    g = {"a": rng.normal(size=(10,)) * 100, "b": rng.normal(size=(3, 4))}
    tdt = getattr(torch, dtype)
    grads = {k: torch.from_numpy(v.astype(np.float32)).to(tdt)
             for k, v in g.items()}
    jgrads = {k: jnp.asarray(v.astype(np.float32), getattr(jnp, dtype))
              for k, v in g.items()}
    clipped, gn = clip_by_global_norm(grads, 1.0)
    jclipped, jgn = jax_clip(jgrads, 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for k in g:
        assert clipped[k].dtype == torch.float32     # jnp's promotion
        np.testing.assert_allclose(np_of(clipped[k]), np.asarray(jclipped[k]),
                                   **TOL)


# --- the reference's own checks (tests/test_optim_compression.py) ------


def _rosenbrock_ish(params):
    return torch.sum((params["w"] - 3.0) ** 2) + torch.sum(
        (params["m"] @ params["m"].T - torch.eye(4)) ** 2)


@pytest.mark.parametrize("make_opt", [lambda: adamw(1e-1),
                                      lambda: adafactor(1e-1)],
                         ids=["adamw", "adafactor"])
def test_optimizers_descend(make_opt):
    params = {"w": torch.zeros((8,)), "m": torch.eye(4) * 0.3}
    opt = make_opt()
    state = opt.init(params)
    loss0 = float(_rosenbrock_ish(params))
    for _ in range(60):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        gw, gm = torch.autograd.grad(_rosenbrock_ish(leaves),
                                     [leaves["w"], leaves["m"]])
        updates, state = opt.update({"w": gw, "m": gm}, state, params)
        params = apply_updates(params, updates)
    assert float(_rosenbrock_ish(params)) < 0.2 * loss0


def test_adafactor_state_is_factored():
    state = adafactor(1e-2).init({"big": torch.zeros((128, 256))})
    assert tuple(state.vr["big"].shape) == (128,)
    assert tuple(state.vc["big"].shape) == (256,)


def test_clip_by_global_norm():
    clipped, gn = clip_by_global_norm({"a": torch.full((10,), 100.0)}, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(10) * 100)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)
