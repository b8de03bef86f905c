"""``attention_block`` takes the flash-attention op where no gradient is
taken, causal or not, and ``chunked_attention`` under autograd; both
routes are held against the reference's ``attention_block`` (CPU, f32 at
F32_TOL), and the eval step runs the flash op once a layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as TA
from repro_torch.models.registry import build_model
from repro_torch.training.loop import batch_to_device
from repro_torch.training.step import make_eval_step, value_and_grad
from torch_parity import ARCHS, F32_TOL, configs, np_of, params


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    real = TA.flash_attention

    def counted(q, k, v, causal=True):
        calls.append(tuple(q.shape) if causal else (tuple(q.shape), "full"))
        return real(q, k, v, causal)
    monkeypatch.setattr(TA, "flash_attention", counted)
    return calls


def _layer_inputs(arch, seq=40):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    x = np.random.default_rng(4).normal(
        size=(2, seq, tcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            tp["layers"][0]["attn"], x)


@pytest.mark.parametrize("route", ["flash_no_grad", "chunked_autograd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_both_routes_match_reference(arch, route, flash_calls):
    jcfg, tcfg, jp, tp, x = _layer_inputs(arch)
    want = jax.jit(lambda p, x_: JA.attention_block(p, x_, jcfg))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    if route == "flash_no_grad":
        with torch.no_grad():
            got = TA.attention_block(tp, xt, tcfg)
        assert flash_calls == [(2, 40, tcfg.n_heads, tcfg.resolved_head_dim)]
    else:
        got = TA.attention_block(tp, xt.clone().requires_grad_(True), tcfg)
        assert flash_calls == [] and got.grad_fn is not None
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


def test_params_without_grad_take_flash_too(flash_calls):
    """Grad mode on, nothing requiring grad (a serving or eval call
    outside no_grad): no gradient can be taken, so the flash op runs."""
    _, tcfg, _, tp, x = _layer_inputs("qwen2-0.5b")
    TA.attention_block(tp, torch.from_numpy(x), tcfg)
    assert len(flash_calls) == 1


def test_non_causal_keeps_chunked_attention(flash_calls):
    """The non-causal product (an encoder's) keeps chunked_attention under
    autograd, and takes the flash op without a mask where no gradient is
    taken; both against the reference's."""
    jcfg, tcfg, jp, tp, x = _layer_inputs("qwen3-4b")
    want = JA.attention_block(jp, jnp.asarray(x), jcfg, causal=False)
    got = TA.attention_block(tp, torch.from_numpy(x).requires_grad_(True),
                             tcfg, causal=False)
    assert flash_calls == [] and got.grad_fn is not None
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)
    with torch.no_grad():
        got = TA.attention_block(tp, torch.from_numpy(x), tcfg, causal=False)
    assert flash_calls == [((2, 40, tcfg.n_heads, tcfg.resolved_head_dim),
                            "full")]
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


def test_eval_step_runs_flash_once_a_layer(flash_calls):
    """The eval step (no_grad) launches the flash op n_layers times and
    equals the loss a gradient-taking pass computes (chunked route)."""
    from repro.data.lm import LMDataConfig, make_batch
    jcfg, tcfg = configs("qwen2-0.5b")
    _, tp = params(jcfg)
    bundle = build_model(tcfg)
    batch = batch_to_device(make_batch(LMDataConfig(
        vocab_size=tcfg.vocab_size, seq_len=32, global_batch=2), 0),
        torch.device("cpu"))
    ev = make_eval_step(bundle)(tp, batch)
    assert len(flash_calls) == tcfg.n_layers
    met, _ = value_and_grad(tp, batch, bundle)
    assert len(flash_calls) == tcfg.n_layers
    np.testing.assert_allclose(float(ev["loss"]), float(met["loss"]),
                               rtol=1e-6)
