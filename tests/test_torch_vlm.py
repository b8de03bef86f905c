"""The port's VLM family (qwen2-vl-2b, reduced: M-RoPE over precomputed
embeddings) vs the JAX reference on the CPU, same params and inputs.

``apply_mrope`` against ``repro``'s, then the bundle's ``apply_train``,
``apply_hidden``, ``prefill`` and greedy ``decode_step``s (of tokens, and
of embeddings through ``lm_decode_step(embeds=)``) with a (3, B, S)
position grid that is not arange (a patch grid of rows and columns between
two runs of text, as Qwen2-VL lays an image out), the slotted decode at
M-RoPE positions, and one train step with 2 microbatches, so that
``positions`` splits on its axis 1.  The slotted and paged prefill refuse
M-RoPE models, where the reference fails with an IndexError.  Params are
the reference's ``init_lm`` draws (norm scales and QKV biases perturbed),
copied with ``params_from_jax``.  f32; ``F32_TOL`` (1e-5) on functions and
logits, gradient leaves within 1e-4 of the leaf's largest element.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.common import apply_mrope as jax_mrope
from repro.models.registry import build_model as jax_build_model
from repro.models.transformer import lm_decode_step as jax_decode_step
from repro.models.transformer import (
    lm_decode_step_slotted as jax_decode_slotted,
)
from repro.training.step import TrainState as JaxTrainState
from repro.training.step import loss_fn as jax_loss_fn
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.models.common import apply_mrope
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import (
    lm_decode_step,
    lm_decode_step_slotted,
)
from repro_torch.optim.adamw import stack_lists
from repro_torch.training.step import (
    TrainState,
    loss_fn,
    make_train_step,
    value_and_grad,
)
from repro_torch.weights import params_from_jax
from torch_parity import F32_TOL, np_of, one_thread  # noqa: F401 (fixture)

ARCH = "qwen2-vl-2b"
D = 128                                # the reduced config's d_model


@functools.lru_cache(maxsize=None)
def _setup(microbatches=1):
    jcfg = dataclasses.replace(jax_reduced_config(ARCH),
                               microbatches=microbatches)
    tcfg = dataclasses.replace(reduced_config(ARCH),
                               microbatches=microbatches)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if path[-1].key in ("scale", "q_b", "k_b", "v_b"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jb, tb, jax.tree.map(jnp.asarray, tree), params_from_jax(tree,
                                                                    "cpu")


def grid_positions(b: int, text: int, grid: int, tail: int) -> np.ndarray:
    """(3, b, text + grid^2 + tail) M-RoPE ids: ``text`` tokens at (i, i,
    i), a ``grid`` x ``grid`` patch grid at a fixed t with h and w running
    over its rows and columns, then text again from the grid's largest id
    + 1, as Qwen2-VL lays out an image between text."""
    t = np.arange(text)
    g0 = text
    gh, gw = np.divmod(np.arange(grid * grid), grid)
    start = g0 + grid
    after = start + np.arange(tail)
    pos = np.stack([np.concatenate([t, np.full(grid * grid, g0), after]),
                    np.concatenate([t, g0 + gh, after]),
                    np.concatenate([t, g0 + gw, after])])
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(
        np.int32).copy()


def _inputs(seed=0, b=2, text=4, grid=4, tail=6, labels=False):
    rng = np.random.default_rng(seed)
    pos = grid_positions(b, text, grid, tail)
    emb = rng.normal(size=(b, pos.shape[2], D)).astype(np.float32)
    j = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}
    t = {"embeds": torch.from_numpy(emb),
         "positions": torch.from_numpy(pos)}
    if labels:
        lab = rng.integers(0, 512, pos.shape[1:]).astype(np.int32)
        j["labels"], t["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
    return j, t


def _close(got, want):
    np.testing.assert_allclose(np_of(got), np.asarray(want, np.float32),
                               **F32_TOL)


def test_grid_positions_lay_out_text_grid_text():
    pos = grid_positions(1, 2, 3, 2)[:, 0]
    assert pos.tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 5, 6],
                            [0, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6],
                            [0, 1, 2, 3, 4, 2, 3, 4, 2, 3, 4, 5, 6]]


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 20, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 20)).astype(np.int32)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    _close(got, jax_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))


def test_apply_mrope_refuses_sections_off_the_half_dim():
    with pytest.raises(ValueError, match="do not sum"):
        apply_mrope(torch.zeros(1, 2, 1, 32), torch.zeros(3, 1, 2), 1e6,
                    (4, 6, 5))


def test_apply_train_and_hidden_match_reference():
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs()
    jlogits, _ = jax.jit(jb.apply_train)(jp, jin)
    jhidden, _ = jax.jit(jb.apply_hidden)(jp, jin)
    logits, _ = tb.apply_train(tp, tin)
    hidden, _ = tb.apply_hidden(tp, tin)
    _close(logits.detach(), jlogits)
    _close(hidden.detach(), jhidden)


def test_prefill_and_decode_steps_match_reference():
    """Prefill (flash, causal) at the grid positions, then five greedy
    decode steps at the cache length, as the reference decodes."""
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs(1)
    cache_len = 40
    jlogits, jcache = jax.jit(lambda p, b: jb.prefill(
        p, dict(b, cache_len=cache_len)))(jp, jin)
    with torch.no_grad():
        logits, cache = tb.prefill(tp, dict(tin, cache_len=cache_len))
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    jstep = jax.jit(jb.decode_step)
    tok = np.argmax(np.asarray(jlogits), -1)[:, None].astype(np.int32)
    for _ in range(5):
        jlogits, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            logits, cache = tb.decode_step(tp, cache, {
                "tokens": torch.from_numpy(tok).long()})
        _close(logits, jlogits)
        tok = np.argmax(np.asarray(jlogits), -1)[:, None].astype(np.int32)
    assert cache["len"] == int(jcache["len"])


def test_decode_steps_from_embeddings_match_reference():
    """``lm_decode_step`` on one embedding a row (B, 1, D), as a VLM
    decodes a patch, against the reference's ``embeds=`` at the same
    cache: three steps after a prefill at the grid positions."""
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs(4)
    cache_len = 40
    _, jcache = jax.jit(lambda p, b: jb.prefill(
        p, dict(b, cache_len=cache_len)))(jp, jin)
    with torch.no_grad():
        _, cache = tb.prefill(tp, dict(tin, cache_len=cache_len))
    rng = np.random.default_rng(5)
    jstep = jax.jit(lambda p, c, e: jax_decode_step(p, c, None, jb.cfg,
                                                    embeds=e))
    for _ in range(3):
        emb = rng.normal(size=(2, 1, D)).astype(np.float32)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(emb))
        with torch.no_grad():
            logits, cache = lm_decode_step(tp, cache, None, tb.cfg,
                                           embeds=torch.from_numpy(emb))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    assert cache["len"] == int(jcache["len"])


def test_slotted_decode_at_mrope_positions_matches_reference():
    """The engine's slotted decode step broadcasts each slot's length to
    the three M-RoPE components, as the reference's does."""
    jb, tb, jp, tp = _setup()
    cfg = tb.cfg
    rng = np.random.default_rng(2)
    b, s = 3, 24
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    lens = np.array([3, 17, 9], np.int32)
    tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
    active = np.array([True, True, False])
    jl, jc = jax.jit(lambda p, c, t, a: jax_decode_slotted(
        p, c, t, a, jb.cfg))(jp, {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                   "lens": jnp.asarray(lens)},
                             jnp.asarray(tok), jnp.asarray(active))
    with torch.no_grad():
        tl, tc = lm_decode_step_slotted(
            tp, {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                 "lens": torch.from_numpy(lens)},
            torch.from_numpy(tok).long(), torch.from_numpy(active), cfg)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    assert tc["lens"].tolist() == np.asarray(jc["lens"]).tolist()


@pytest.mark.parametrize("path", ["prefill_slotted", "prefill_paged"])
def test_token_prefill_refuses_mrope(path):
    _, tb, _, tp = _setup()
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "lens": torch.tensor([4], dtype=torch.int32), "cache_len": 8}
    with pytest.raises(ValueError, match="M-RoPE"):
        getattr(tb, path)(tp, batch)


def test_train_step_with_two_microbatches_matches_reference():
    """loss_fn's terms and every gradient leaf of one ``{"embeds",
    "positions", "labels"}`` batch, then one whole train step with 2
    microbatches (positions split on axis 1) on both sides: loss and grad
    norm to 1e-5 relative."""
    jb, tb, jp, tp = _setup(microbatches=2)
    jin, tin = _inputs(3, b=4, labels=True)
    total, met = loss_fn(tp, tin, tb)
    jtotal, jmet = jax.jit(lambda p, b: jax_loss_fn(p, b, jb))(jp, jin)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _, grads = value_and_grad(tp, tin, tb)
    jgrads = jax.jit(jax.grad(lambda p, b: jax_loss_fn(p, b, jb)[0]))(jp,
                                                                        jin)
    stacked = stack_lists(grads)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        got = stacked
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        err = np.abs(np_of(got) - want).max()
        assert err <= 1e-4 * np.abs(want).max(), jax.tree_util.keystr(path)
    step, opt = make_train_step(tb)
    jstep, jopt = jax_make_train_step(jb)
    tp = jax.tree.map(lambda t: t.clone(), tp)
    state, met = step(TrainState(0, tp, opt.init(tp)), tin)
    _, jmet = jax.jit(jstep)(JaxTrainState(jnp.zeros((), jnp.int32), jp,
                                           jopt.init(jp)), jin)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert state.step == 1
