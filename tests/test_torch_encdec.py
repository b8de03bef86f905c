"""The port's encoder-decoder (whisper-tiny, reduced) vs the JAX reference
on the CPU, same params and inputs.

``repro_torch.models.encdec`` is held against ``repro.models.encdec``
function for function through both packages' ``ModelBundle``: ``encode``,
the teacher-forced forward and hidden states, ``prefill`` (last-token
logits and all four caches) and several greedy ``decode_step``s, and one
train step (loss terms and every gradient leaf).  Params are the
reference's ``init_encdec`` draws with their norm scales and biases
perturbed (they start at exactly 1 and 0), copied with
``params_from_jax``; frames and tokens come from a numpy stream.  f32
throughout; ``F32_TOL`` (1e-5) on single functions and on logits (four
to five layers of f32 sums in another order stay near 1e-6); gradient
leaves within 1e-4 of the leaf's largest element, as
tests/test_torch_train_step.py holds the LM families.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.shapes import ENCDEC_DECODE_ENC_LEN as JAX_ENC_LEN
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import encdec as jax_encdec
from repro.models.attention import cross_attention_block as jax_cross
from repro.models.common import sinusoidal_positions as jax_sinusoid
from repro.models.registry import build_model as jax_build_model
from repro.training.step import loss_fn as jax_loss_fn
from repro_torch.configs import reduced_config
from repro_torch.configs.shapes import ENCDEC_DECODE_ENC_LEN, SHAPES
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec
from repro_torch.models.attention import cross_attention_block
from repro_torch.models.common import sinusoid, sinusoidal_positions
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import stack_lists
from repro_torch.training.step import loss_fn, value_and_grad
from repro_torch.weights import params_from_jax
from torch_parity import F32_TOL, np_of, one_thread  # noqa: F401 (fixture)

ARCH = "whisper-tiny"
T_ENC, S_DEC, BATCH = 80, 6, 2        # 80 frames: a ragged 64-frame chunk


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def one(path, a):
        if path[-1].key in ("scale", "bias", "q_b", "k_b", "v_b"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax bundle, port bundle, jax params, port params) of reduced
    whisper-tiny; neither side writes its params."""
    jcfg, tcfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(0)))
    tree = _perturb(tree, 0)
    return jb, tb, jax.tree.map(jnp.asarray, tree), params_from_jax(tree,
                                                                    "cpu")


def _inputs(seed=0, batch=BATCH, t_enc=T_ENC, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(batch, t_enc, 128)).astype(np.float32)
    dec = rng.integers(0, 512, (batch, s_dec)).astype(np.int32)
    labels = rng.integers(0, 512, (batch, s_dec)).astype(np.int32)
    return ({"frames": jnp.asarray(frames), "dec_tokens": jnp.asarray(dec),
             "labels": jnp.asarray(labels)},
            {"frames": torch.from_numpy(frames),
             "dec_tokens": torch.from_numpy(dec).long(),
             "labels": torch.from_numpy(labels).long()})


def _close(got, want, **tol):
    np.testing.assert_allclose(np_of(got), np.asarray(want, np.float32),
                               **(tol or F32_TOL))


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b",
                                  "granite-34b", "mistral-large-123b"])
def test_configs_are_copies(arch):
    """The config modules this slice copies, field for field, full and
    reduced."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(
        jax_reduced_config(arch))


def test_shape_cells_and_half_ecg_are_copies():
    from repro.configs import half_ecg as jax_half_ecg
    from repro_torch.configs import half_ecg
    assert ENCDEC_DECODE_ENC_LEN == JAX_ENC_LEN == 1500
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    assert half_ecg.TABLE1_OBJECTIVES == jax_half_ecg.TABLE1_OBJECTIVES
    assert dataclasses.asdict(half_ecg.SPACE) == dataclasses.asdict(
        jax_half_ecg.SPACE)


@pytest.mark.parametrize("length,d", [(1, 128), (7, 384), (1500, 384)])
def test_sinusoidal_positions_match_reference(length, d):
    """Row p's angles are p * exp(...): the two libraries' f32 exp may
    differ by an ulp (2^-24 relative, at most 1), which position p scales
    to p * 2^-24 in the angle and so in its sine; at p < 1500 that is up
    to 9e-5, so the bound is 1e-5 plus two such ulps of the last row."""
    atol = 1e-5 + 2 * (length - 1) * 2.0 ** -24
    _close(sinusoidal_positions(length, d), jax_sinusoid(length, d),
           rtol=1e-5, atol=atol)


def test_decode_position_row_is_the_table_row():
    """The decode step's position embedding, ``sinusoid`` of its one
    position as the reference computes it, is row ``pos`` of the table."""
    table = sinusoidal_positions(448, 384)
    for pos in (0, 1, 4, 447):
        torch.testing.assert_close(sinusoid(torch.tensor(float(pos)), 384),
                                   table[pos], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s_dec,t_enc", [(1, 80), (6, 80), (5, 1)])
def test_cross_attention_block_matches_reference(s_dec, t_enc):
    jb, tb, jp, tp = _setup()
    cfg = tb.cfg
    rng = np.random.default_rng(s_dec * t_enc)
    x = rng.normal(size=(BATCH, s_dec, 128)).astype(np.float32)
    enc = rng.normal(size=(BATCH, t_enc, 128)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross"])
    want = jax_cross(lp, jnp.asarray(x), jnp.asarray(enc), jb.cfg)
    for grad in (False, True):       # flash op, then chunked_attention
        with torch.set_grad_enabled(grad):
            xt = torch.from_numpy(x).requires_grad_(grad)
            got = cross_attention_block(tp["dec_layers"][0]["cross"], xt,
                                        torch.from_numpy(enc), cfg)
        _close(got.detach(), want)


def test_encode_matches_reference():
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs()
    want = jax.jit(lambda p, f: jax_encdec.encode(p, f, jb.cfg))(
        jp, jin["frames"])
    with torch.no_grad():
        _close(encdec.encode(tp, tin["frames"], tb.cfg), want)


def test_apply_train_and_hidden_match_reference():
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs(1)
    jlogits, _ = jax.jit(jb.apply_train)(jp, jin)
    jhidden, _ = jax.jit(jb.apply_hidden)(jp, jin)
    logits, aux = tb.apply_train(tp, tin)
    hidden, _ = tb.apply_hidden(tp, tin)
    _close(logits.detach(), jlogits)
    _close(hidden.detach(), jhidden)
    assert float(aux) == 0.0
    _close(tb.unembed_chunk(tp, hidden).detach(), jlogits)


def test_prefill_and_decode_steps_match_reference():
    """Prefill's last-token logits and its four caches, then five greedy
    decode steps fed the reference's tokens."""
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs(2)
    cache_len = 16
    jlogits, jcache = jax.jit(lambda p, b: jb.prefill(
        p, dict(b, cache_len=cache_len)))(jp, jin)
    with torch.no_grad():
        logits, cache = tb.prefill(tp, dict(tin, cache_len=cache_len))
    _close(logits, jlogits)
    for k in ("k", "v", "ck", "cv"):
        assert tuple(cache[k].shape) == jcache[k].shape, k
        _close(cache[k], jcache[k])
    assert cache["len"] == int(jcache["len"]) == S_DEC
    jstep = jax.jit(jb.decode_step)
    tok = np.argmax(np.asarray(jlogits), -1)[:, None].astype(np.int32)
    for i in range(5):
        jlogits, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            logits, cache = tb.decode_step(tp, cache, {
                "tokens": torch.from_numpy(tok).long()})
        _close(logits, jlogits)
        tok = np.argmax(np.asarray(jlogits), -1)[:, None].astype(np.int32)
    assert cache["len"] == S_DEC + 5
    _close(cache["k"], jcache["k"])


def test_decode_runs_the_decode_op_for_both_attentions(monkeypatch):
    """A decode step calls the decode-attention op twice a layer: the
    cached self-attention at kv_len = len + 1 and the cross-attention at
    kv_len = T_enc; a prefill calls the flash op three times a layer
    (encoder self-attention unmasked, decoder self-attention causal,
    cross-attention unmasked)."""
    from repro_torch.models import attention
    _, tb, _, tp = _setup()
    _, tin = _inputs(3)
    flash, dec = [], []
    real_flash = attention.flash_attention
    real_dec = attention.decode_attention
    monkeypatch.setattr(attention, "flash_attention", lambda q, k, v, causal:
                        flash.append((q.shape[1], k.shape[1], causal))
                        or real_flash(q, k, v, causal))
    monkeypatch.setattr(attention, "decode_attention", lambda q, k, v, kv:
                        dec.append(kv.tolist()) or real_dec(q, k, v, kv))
    cfg = tb.cfg
    with torch.no_grad():
        _, cache = tb.prefill(tp, dict(tin, cache_len=16))
        tb.decode_step(tp, cache, {"tokens": torch.zeros(BATCH, 1).long()})
    assert flash == [(T_ENC, T_ENC, False)] * cfg.n_layers + [
        (S_DEC, S_DEC, True), (S_DEC, T_ENC, False)] * cfg.n_dec_layers
    assert dec == [[S_DEC + 1] * BATCH, [T_ENC] * BATCH] * cfg.n_dec_layers


def test_make_cache_holds_the_reference_encoder_length():
    _, tb, _, _ = _setup()
    cache = tb.make_cache(2, 32, device="cpu")
    assert tuple(cache["ck"].shape) == (2, 2, ENCDEC_DECODE_ENC_LEN, 4, 32)
    assert tuple(cache["k"].shape) == (2, 2, 32, 4, 32)
    assert cache["len"] == 0 and set(cache) == set(tb.cache_specs())


def test_params_from_jax_unstacks_both_stacks():
    _, tb, jp, tp = _setup()
    assert len(tp["enc_layers"]) == tb.cfg.n_layers
    assert len(tp["dec_layers"]) == tb.cfg.n_dec_layers
    init = tb.init(0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape),  # noqa: E731
                                    stack_lists(t))
    assert shapes(init) == shapes(tp) == jax.tree.map(lambda a: a.shape, jp)


def test_train_step_loss_and_grads_match_reference():
    """loss_fn's terms and every gradient leaf of one
    ``{"frames", "dec_tokens", "labels"}`` batch."""
    jb, tb, jp, tp = _setup()
    jin, tin = _inputs(4)
    total, met = loss_fn(tp, tin, tb)
    jtotal, jmet = jax.jit(lambda p, b: jax_loss_fn(p, b, jb))(jp, jin)
    for k in ("loss", "z_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
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


@pytest.mark.parametrize("arch,match", [
    ("whisper-tiny", "has no slotted serving path"),
    ("qwen2-vl-2b", "M-RoPE"),
])
def test_launcher_refuses_the_families_without_token_prompts(arch, match):
    """The reference's launcher refuses the encoder-decoder with this
    error and fails on the VLM with an IndexError in its slotted prefill;
    the port refuses both before it draws any weights."""
    with pytest.raises(ValueError, match=match):
        launch_serve.main(["--arch", arch, "--device", "cpu", "--engine"])
