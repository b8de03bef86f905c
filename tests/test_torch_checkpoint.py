"""The port's Checkpointer: the reference's checks (tests/
test_checkpoint_loop.py: round trip, gc and latest, async then wait, a
partial .tmp ignored), bf16 bits kept, a snapshot independent of later
in-place writes, and checkpoints crossing between the packages both ways
(a reference TrainState restores into the port's through
``train_state_from_jax``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.training.step import TrainState as JaxTrainState
from repro.training.step import make_optimizer as jax_make_optimizer
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten_with_path
from repro_torch.optim import adamw
from repro_torch.training.step import TrainState, make_optimizer
from repro_torch.weights import params_from_jax, train_state_from_jax
from torch_parity import configs, hybrid_configs, hybrid_params, np_of, params


def _state():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16),
                       "step": 3},
            "layers": [{"w": torch.full((2,), float(i))} for i in range(2)]}


def _leaves_equal(a, b):
    la, lb = list(flatten_with_path(a)), list(flatten_with_path(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, name
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        else:
            assert type(x) is type(y) and x == y, name


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = TrainState(5, _state(), adamw(1e-3).init(_state()["layers"]))
    ck.save(10, state)
    like = TrainState(0, {"a": torch.zeros(2, 3),
                          "nested": {"b": torch.zeros(4, dtype=torch.bfloat16),
                                     "step": 0},
                          "layers": [{"w": torch.zeros(2)} for _ in range(2)]},
                      adamw(1e-3).init([{"w": torch.zeros(2)}] * 2))
    step, restored = ck.restore(like)
    assert step == 10 and isinstance(restored, TrainState)
    _leaves_equal(state, restored)


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state())
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async_then_wait(tmp_path):
    """The snapshot is taken at save_async: writing the state in place
    afterwards (as a train step writes its params) does not reach it."""
    ck = Checkpointer(str(tmp_path), keep=3)
    state = _state()
    ck.save_async(7, state)
    state["a"].add_(100.0)
    ck.wait()
    assert ck.latest_step() == 7
    _, restored = ck.restore(_state())
    torch.testing.assert_close(restored["a"], _state()["a"])


def test_checkpoint_ignores_partial_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    os.makedirs(tmp_path / "step_0000000099.tmp")  # crashed mid-save
    ck.save(5, _state())
    assert ck.latest_step() == 5  # tmp dir never counts


def test_restore_refuses_a_missing_leaf_or_shape(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf b"):
        ck.restore({"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore({"a": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"a": torch.zeros(3)})


def test_bf16_bits_preserved(tmp_path):
    """Every bf16 bit pattern of a random tensor, NaN payloads and
    negative zero included, comes back unchanged; on disk it is the
    reference's uint16 with the logical dtype in the index."""
    bits = torch.from_numpy(np.random.default_rng(0).integers(
        -2**15, 2**15, size=(4096,), dtype=np.int16))
    state = {"w": bits.view(torch.bfloat16)}
    ck = Checkpointer(str(tmp_path))
    path = ck.save(3, state)
    assert np.load(os.path.join(path, "w.npy")).dtype == np.uint16
    _, restored = ck.restore({"w": torch.zeros(4096, dtype=torch.bfloat16)})
    assert torch.equal(restored["w"].view(torch.int16), bits)
    _, tree = ck.restore_tree()
    assert torch.equal(tree["w"].view(torch.int16), bits)


def test_reference_restores_a_port_checkpoint(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": torch.linspace(-3, 3, 5).to(torch.bfloat16), "step": 4}
    Checkpointer(str(tmp_path)).save(2, state)
    like = {"a": jax.ShapeDtypeStruct((2, 3), jnp.float32),
            "b": jax.ShapeDtypeStruct((5,), jnp.bfloat16),
            "step": jax.ShapeDtypeStruct((), jnp.int32)}
    step, got = JaxCheckpointer(str(tmp_path)).restore(like)
    assert step == 2 and int(got["step"]) == 4
    np.testing.assert_array_equal(np.asarray(got["a"]), np_of(state["a"]))
    np.testing.assert_array_equal(np.asarray(got["b"], np.float32),
                                  np_of(state["b"].float()))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_a_reference_train_state(tmp_path, arch, dtype):
    """A TrainState (params, AdamW m and v) written by the reference's
    Checkpointer restores into the port's layout, every leaf equal."""
    import dataclasses
    if arch == "zamba2-7b":
        jcfg, _ = hybrid_configs(arch)
        jp, _ = hybrid_params(jcfg)
    else:
        jcfg, _ = configs(arch)
        jp, _ = params(jcfg)
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    opt = jax_make_optimizer(dataclasses.replace(jcfg, dtype=dtype))
    rng = np.random.default_rng(1)
    jstate = JaxTrainState(jnp.asarray(3, jnp.int32), jp, opt.init(jp))
    jstate = jstate._replace(opt_state=jstate.opt_state._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                             jnp.float32),
                       jstate.opt_state.m)))
    JaxCheckpointer(str(tmp_path)).save(3, jstate)
    step, tree = Checkpointer(str(tmp_path)).restore_tree()
    state = train_state_from_jax(tree, "cpu")
    assert step == 3 and state.step == 3 and state.opt_state.step == 3
    host = jax.tree.map(np.asarray, jstate)
    want = TrainState(3, params_from_jax(host.params, "cpu"),
                      make_optimizer(jcfg).init(params_from_jax(
                          host.params, "cpu"))._replace(
                          step=3, m=params_from_jax(host.opt_state.m, "cpu"),
                          v=params_from_jax(host.opt_state.v, "cpu")))
    _leaves_equal(state, want)
    assert state.params["embed"].dtype == getattr(torch, dtype)
