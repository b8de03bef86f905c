"""The port's training step vs the reference's (CPU, reduced configs, f32):
``loss_fn``'s terms, the gradient of every leaf, the chunked loss, the
microbatch split, the three remat modes and five whole train steps.

Params are the reference's own ``init_lm`` / ``init_hybrid`` draws copied
with ``params_from_jax``; batches come from the shared numpy LM stream.
Tolerances: the loss terms 1e-5 relative and five steps' losses 1e-4
relative (torch and XLA reduce in different orders, and five AdamW steps
carry that on); each gradient leaf within 1e-4 of its largest element;
the port against itself (chunked, microbatched, rematerialised) 1e-6 and
1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm import LMDataConfig, make_batch
from repro.models.registry import build_model as jax_build_model
from repro.training.step import loss_fn as jax_loss_fn
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import stack_lists, tree_map
from repro_torch.training.loop import batch_to_device
from repro_torch.training.step import (
    TrainState,
    loss_fn,
    make_eval_step,
    make_train_step,
    value_and_grad,
)
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    configs,
    hybrid_configs,
    hybrid_params,
    np_of,
    one_thread,
    params,
)

ARCHS = ["qwen2-0.5b", "dbrx-132b", "mamba2-780m", "zamba2-7b"]
SEQ, BATCH = 32, 4


def _setup(arch, **changes):
    """(jax cfg, port cfg, jax params, port params (fresh copies))."""
    hybrid = arch in ("mamba2-780m", "zamba2-7b")
    jcfg, tcfg = hybrid_configs(arch) if hybrid else configs(arch)
    jp, tp = hybrid_params(jcfg) if hybrid else params(jcfg)
    tp = tree_map(lambda t: t.clone(), tp)
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(tcfg, **changes), jp, tp)


def _batch(cfg, step=0, batch=BATCH):
    b = make_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                global_batch=batch), step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            batch_to_device(b, torch.device("cpu")))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_terms_match_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    jb, tb = _batch(tcfg)
    total, met = loss_fn(tp, tb, build_model(tcfg))
    jtotal, jmet = jax.jit(lambda p, b: jax_loss_fn(
        p, b, jax_build_model(jcfg)))(jp, jb)
    for k in ("loss", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    if arch == "dbrx-132b":
        assert float(met["moe_aux"]) > 0


def _stacked_close(grads, jgrads, rel):
    stacked = stack_lists(grads)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        got = stacked
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        err = np.abs(np_of(got) - want).max()
        assert err <= rel * np.abs(want).max(), \
            f"{jax.tree_util.keystr(path)}: {err} vs max {np.abs(want).max()}"


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    """Every leaf's gradient within 1e-4 of the leaf's largest element."""
    jcfg, tcfg, jp, tp = _setup(arch)
    jb, tb = _batch(tcfg)
    _, grads = value_and_grad(tp, tb, build_model(tcfg))
    jbundle = jax_build_model(jcfg)
    jgrads = jax.jit(jax.grad(
        lambda p, b: jax_loss_fn(p, b, jbundle)[0]))(jp, jb)
    _stacked_close(grads, jgrads, 1e-4)
    # the params come back as they went in: plain tensors, no grad
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(
        stack_lists(tp)))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_chunked_loss_equals_plain_loss(arch):
    _, tcfg, _, tp = _setup(arch)
    _, tb = _batch(tcfg)
    plain_met, plain = value_and_grad(tp, tb, build_model(tcfg))
    chunked_cfg = dataclasses.replace(tcfg, chunked_loss=True)
    met, grads = value_and_grad(tp, tb, build_model(chunked_cfg))
    for k in plain_met:
        np.testing.assert_allclose(float(met[k]), float(plain_met[k]),
                                   rtol=1e-6, atol=1e-9)
    tree_map(lambda a, b: torch.testing.assert_close(
        a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max())), grads, plain)
    # the eval step (no gradient) takes the same chunks
    ev = make_eval_step(build_model(chunked_cfg))(tp, tb)
    np.testing.assert_allclose(float(ev["loss"]), float(plain_met["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_two_microbatches_equal_one(arch):
    """Gradients and metrics of 2 microbatches of 2 rows against 1 of 4,
    to 1e-5.  Not for MoE: its load-balance loss is a product of two batch
    means, so its microbatches' mean is another function in both packages
    (the five-step test holds the port's split to the reference's)."""
    _, tcfg, _, tp = _setup(arch)
    _, tb = _batch(tcfg)
    one, _ = make_train_step(build_model(tcfg))
    two, _ = make_train_step(build_model(
        dataclasses.replace(tcfg, microbatches=2)))
    met1, g1 = one.grads(tp, tb)
    met2, g2 = two.grads(tp, tb)
    for k in ("loss", "z_loss"):
        np.testing.assert_allclose(float(met2[k]), float(met1[k]), rtol=1e-5)
    tree_map(lambda a, b: torch.testing.assert_close(
        a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max())), g2, g1)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b", "zamba2-7b"])
def test_remat_modes_give_the_same_grads(arch):
    _, tcfg, _, tp = _setup(arch)
    _, tb = _batch(tcfg)
    out = {mode: value_and_grad(tp, tb, build_model(
        dataclasses.replace(tcfg, remat=mode))) for mode in
        ("none", "full", "dots")}
    for mode in ("full", "dots"):
        np.testing.assert_allclose(float(out[mode][0]["loss"]),
                                   float(out["none"][0]["loss"]), rtol=1e-6)
        tree_map(lambda a, b: torch.testing.assert_close(
            a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max())),
            out[mode][1], out["none"][1])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b", "zamba2-7b"])
def test_five_train_steps_match_reference(arch):
    """Five steps of make_train_step on both sides (AdamW, clip 1.0, two
    microbatches, remat "full" as the published configs train), from the
    same params and batches: every step's loss and grad norm to 1e-4
    relative.  (Not the params elementwise: AdamW moves an element whose
    gradient is near zero by about lr either way, whichever sign the
    summation order gives it.)"""
    jcfg, tcfg, jp, tp = _setup(arch, microbatches=2, remat="full")
    step, opt = make_train_step(build_model(tcfg))
    jstep, jopt = jax_make_train_step(jax_build_model(jcfg))
    jstep = jax.jit(jstep)
    from repro.training.step import TrainState as JaxTrainState
    state = TrainState(0, tp, opt.init(tp))
    jstate = JaxTrainState(jnp.zeros((), jnp.int32), jp, jopt.init(jp))
    for i in range(5):
        jb, tb = _batch(tcfg, step=i)
        state, met = step(state, tb)
        jstate, jmet = jstep(jstate, jb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert state.step == int(jstate.step) == 5
