"""Port MoE family vs the JAX reference on the CPU, same inputs.

``moe_block`` (the reference's sort path: no mesh, as on one card), its
capacity drops, and the MoE LM's every entry point, for reduced dbrx-132b
(8 experts, top-2) and reduced kimi-k2 (the same plus a shared expert),
with the reference's params carried over by ``params_from_jax``.  f32
throughout, compared at ``F32_TOL`` (torch and XLA reduce in different
orders); serving against training on the port alone at the reference's
own 2e-3 (tests/test_models.py), with no pair dropped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_jax
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    F32_TOL,
    MOE_ARCHS,
    configs,
    np_of,
    one_thread,
    params,
)


def _close(a, b, **tol):
    np.testing.assert_allclose(np_of(a), np_of(b), **(tol or F32_TOL))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _layer0(arch):
    """(repro cfg, port cfg, layer 0's MoE params on each side)."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    jmoe = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    return jcfg, tcfg, jmoe, tp["layers"][0]["moe"]


@pytest.mark.parametrize("arch", MOE_ARCHS + ["dbrx-132b-full",
                                              "kimi-k2-1t-a32b-full"])
def test_expert_capacity_matches_reference(arch):
    if arch.endswith("-full"):
        name = arch[:-len("-full")]
        jcfg, tcfg = jax_get_config(name), get_config(name)
    else:
        jcfg, tcfg = configs(arch)
    got = [TMoE.expert_capacity(t, tcfg) for t in range(1, 2049)]
    assert got == [JMoE.expert_capacity(t, jcfg) for t in range(1, 2049)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["default", "dropping"])
def test_moe_block_matches_reference(arch, capacity_factor):
    """y and the aux loss; at capacity 0.5 many pairs drop (at the default
    1.25 an expert may overflow too), and the port drops the same ones:
    its y equals the reference's, and differs from the undropped y."""
    jcfg, tcfg, jmoe, tmoe = _layer0(arch)
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    x = np.random.default_rng(3).normal(
        size=(2, 24, jcfg.d_model)).astype(np.float32)
    got, aux = TMoE.moe_block(tmoe, torch.from_numpy(x), tcfg)
    want, jaux = jax.jit(lambda p, x_: JMoE.moe_block(p, x_, jcfg))(
        jmoe, jnp.asarray(x))
    _close(got, want)
    _close(aux, jaux)
    _, _, experts = TMoE.route(tmoe, torch.from_numpy(x).reshape(48, -1),
                               tcfg)
    counts = torch.bincount(experts.reshape(-1), minlength=tcfg.n_experts)
    cap = TMoE.expert_capacity(48, tcfg)
    dropped = int((counts - cap).clamp(min=0).sum())
    if capacity_factor < 1:
        assert dropped > 0
        undropped, _ = TMoE.moe_block(
            tmoe, torch.from_numpy(x),
            dataclasses.replace(tcfg, capacity_factor=8.0))
        assert not torch.allclose(got, undropped)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router logits: the lower expert ids win, as XLA's top_k."""
    _, tcfg, _, tmoe = _layer0("dbrx-132b")
    p = dict(tmoe, router=torch.zeros_like(tmoe["router"]))
    _, gates, experts = TMoE.route(p, torch.ones(3, tcfg.d_model), tcfg)
    assert experts.tolist() == [[0, 1]] * 3
    assert torch.allclose(gates, torch.full((3, 2), 0.5))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_specs_match_reference(arch):
    jcfg, tcfg = configs(arch)
    assert TMoE.moe_specs(tcfg, ("layers",)) == \
        JMoE.moe_specs(jcfg, ("layers",))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_forward_matches_reference(arch):
    """Logits and the aux loss summed over the layers."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (2, 9), 4)
    got, aux = TT.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    want, jaux = jax.jit(lambda p, t: JT.lm_forward(p, jcfg, tokens=t))(
        jp, jnp.asarray(toks))
    _close(got, want)
    _close(aux, jaux)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_prefill_and_decode_step_match_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (2, 7), 5)
    tl, tc = TT.lm_prefill(tp, tcfg, tokens=torch.from_numpy(toks),
                           cache_len=16)
    jl, jc = jax.jit(lambda p, t: JT.lm_prefill(
        p, jcfg, tokens=t, cache_len=16))(jp, jnp.asarray(toks))
    _close(tl, jl)
    j_decode = jax.jit(lambda p, c, t: JT.lm_decode_step(p, c, t, jcfg))
    for step in range(3):
        nxt = _tokens(jcfg, (2, 1), 10 + step)
        tl, tc = TT.lm_decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt))
        _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_slotted_prefill_and_decode_match_reference(arch):
    """Right-padded bucket prefill (the pad tokens are routed too, on both
    sides), then slotted decode with an inactive slot."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (3, 8), 6)
    lens = np.array([8, 3, 5], np.int32)
    tl, tc = TT.lm_prefill_slotted(tp, tcfg, tokens=torch.from_numpy(toks),
                                   lens=torch.from_numpy(lens), cache_len=12)
    jl, jc = jax.jit(lambda p, t, n: JT.lm_prefill_slotted(
        p, jcfg, tokens=t, lens=n, cache_len=12))(
            jp, jnp.asarray(toks), jnp.asarray(lens))
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    active = np.array([True, True, False])
    j_decode = jax.jit(lambda p, c, t, a: JT.lm_decode_step_slotted(
        p, c, t, a, jcfg))
    for step in range(4):
        nxt = _tokens(jcfg, (3, 1), 20 + step)
        tl, tc = TT.lm_decode_step_slotted(
            tp, tc, torch.from_numpy(nxt), torch.from_numpy(active), tcfg)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt), jnp.asarray(active))
        _close(tl[active], np.asarray(jl)[active])
        np.testing.assert_array_equal(np_of(tc["lens"]), np_of(jc["lens"]))
    _close(tc["k"], jc["k"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_paged_prefill_and_decode_match_reference(arch):
    """The paged pair: unpadded prefill rows, then one decode step against
    shuffled pool blocks with an inactive row."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    toks = _tokens(jcfg, (2, 8), 7)
    lens = np.array([8, 5], np.int32)
    tl, rows = TT.lm_prefill_paged(tp, tcfg, tokens=torch.from_numpy(toks),
                                   lens=torch.from_numpy(lens))
    jl, jrows = jax.jit(lambda p, t, n: JT.lm_prefill_paged(
        p, jcfg, tokens=t, lens=n))(jp, jnp.asarray(toks), jnp.asarray(lens))
    _close(tl, jl)
    _close(rows["k"], jrows["k"])
    _close(rows["v"], jrows["v"])

    slots, cache_len, bs, n_blocks = 3, 32, 8, 14
    nb = cache_len // bs
    rng = np.random.default_rng(8)
    shape = (jcfg.n_layers, n_blocks, bs, jcfg.n_kv_heads,
             jcfg.resolved_head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    slot_lens = np.asarray([5, 17, 9], np.int32)
    active = np.asarray([True, True, False])
    perm = rng.permutation(n_blocks)
    tables = np.full((slots, nb), n_blocks, np.int32)
    for s, n in enumerate(slot_lens):
        used = min(n // bs + 1, nb)
        tables[s, :used] = perm[s * nb: s * nb + used]
    nxt = _tokens(jcfg, (slots, 1), 9)
    jl, jc = JT.lm_decode_step_paged(
        jp, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
             "lens": jnp.asarray(slot_lens), "tables": jnp.asarray(tables)},
        jnp.asarray(nxt), jnp.asarray(active), jcfg)
    tc = TT.init_paged_cache(tcfg, slots, cache_len, n_blocks, bs,
                             device="cpu")
    for key, val in (("k", k0), ("v", v0), ("lens", slot_lens),
                     ("tables", tables)):
        tc[key].copy_(torch.from_numpy(val))
    tl, tc = TT.lm_decode_step_paged(tp, tc, torch.from_numpy(nxt),
                                     torch.from_numpy(active), tcfg)
    _close(tl[active], np.asarray(jl)[active])
    _close(tc["k"], jc["k"])
    assert np.array_equal(np_of(tc["lens"]), np.asarray(jc["lens"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_equals_training_on_the_last_token(arch):
    """The reference's own contract (tests/test_models.py), on the port:
    prefill and a decode step give the training forward's last two logits,
    at capacity_factor 8 so that no pair drops (capacity depends on the
    token count of the call)."""
    jcfg, tcfg = configs(arch)
    _, tp = params(jcfg)
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    toks = torch.from_numpy(_tokens(tcfg, (2, 24), 1))
    full, _ = TT.lm_forward(tp, tcfg, tokens=toks)
    pl, cache = TT.lm_prefill(tp, tcfg, tokens=toks[:, :-1], cache_len=32)
    dl, _ = TT.lm_decode_step(tp, cache, toks[:, -1:], tcfg)
    _close(pl, full[:, -2], rtol=2e-3, atol=2e-3)
    _close(dl, full[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_matches_reference_tree(arch, dtype):
    """The port draws its own weights: the reference's tree of shapes and
    dtypes, layer by layer, with the experts' fan-in truncated normals."""
    jcfg, tcfg = configs(arch)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    ref = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    got = TT.init_lm(0, tcfg, device="cpu")
    assert len(got["layers"]) == jcfg.n_layers
    for layer in got["layers"]:
        assert set(layer) == set(ref["layers"])
        for group in ("attn", "moe", "attn_norm", "mlp_norm"):
            assert set(layer[group]) == set(ref["layers"][group])
            for name, leaf in layer[group].items():
                want = ref["layers"][group][name]
                assert tuple(leaf.shape) == want.shape[1:], (group, name)
                assert str(leaf.dtype).split(".")[-1] == str(want.dtype)
    w = got["layers"][0]["moe"]["gate"].float()
    std = 1.0 / np.sqrt(tcfg.d_model)
    assert float(w.abs().max()) <= 2 * std * (1 + 2 ** -7)
    assert abs(float(w.std()) / std - 0.88) < 0.05   # N truncated at 2σ


def test_params_from_jax_maps_moe_leaves_with_their_bits():
    """bf16 expert matrices arrive per layer with the same bits and the
    reference's (E, D, F) layout."""
    jcfg, _ = configs("kimi-k2-1t-a32b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(1), jcfg))
    got = params_from_jax(tree, "cpu")
    for i, layer in enumerate(got["layers"]):
        for name, leaf in layer["moe"].items():
            want = tree["layers"]["moe"][name][i]
            assert leaf.dtype == torch.bfloat16 and leaf.is_contiguous()
            assert np.array_equal(leaf.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert tuple(got["layers"][0]["moe"]["down"].shape) == \
        (jcfg.n_experts, jcfg.moe_d_ff, jcfg.d_model)
