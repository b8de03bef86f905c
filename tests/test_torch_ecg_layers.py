"""The port's layer library and quantization (hwlib/layers.py, quant.py)
against ``repro`` on the same numpy inputs (CPU).

Tolerances: f32 1e-5 where both sides run the same f32 arithmetic in
different orders.  ``fake_quant`` is held bit for bit: its scale is a max
and a division, and ``torch.round`` and ``jnp.round`` both round half to
even, so the same input gives the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hwlib import layers as jlayers
from repro.hwlib import quant as jquant
from repro_torch.hwlib import layers as tlayers
from repro_torch.hwlib import quant as tquant
from repro_torch.kernels.conv1d import dwsep_conv1d
from torch_parity import F32_TOL, np_of

CONV_SPECS = [(16, 7, 1), (8, 5, 2), (2, 1, 4), (32, 3, 2)]  # C_out, K, s


def _conv(c_out, k, s, use_bn=True):
    return (jlayers.LayerSpec(kind="dwsep_conv", out_channels=c_out,
                              kernel_size=k, stride=s, use_bn=use_bn),
            tlayers.LayerSpec(kind="dwsep_conv", out_channels=c_out,
                              kernel_size=k, stride=s, use_bn=use_bn))


def _conv_params(c_in, c_out, k, rng, bn=True):
    p = {"dw": rng.normal(0, 0.5, (k, c_in)),
         "pw": rng.normal(0, 0.5, (c_in, c_out)),
         "b": rng.normal(0, 0.1, (c_out,))}
    if bn:
        p.update(bn_scale=1 + rng.normal(0, 0.1, (c_out,)),
                 bn_bias=rng.normal(0, 0.1, (c_out,)),
                 bn_mean=rng.normal(0, 0.1, (c_out,)),
                 bn_var=rng.uniform(0.5, 2.0, (c_out,)))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _run(tspec, tp, x, mode):
    """The port's apply_layer in one of its three modes: training
    (autograd, batch stats), eval with grad enabled (autograd, running
    stats) and eval without grad (the conv kernel's wrapper)."""
    xt = torch.from_numpy(x)
    if mode == "eval_no_grad":
        with torch.no_grad():
            return np_of(tlayers.apply_layer(tp, tspec, xt))
    return np_of(tlayers.apply_layer(tp, tspec, xt, train=mode == "train"))


@pytest.mark.parametrize("bn", ["bn_keys", "folded", "no_bn_spec"])
@pytest.mark.parametrize("mode", ["train", "eval_grad", "eval_no_grad"])
@pytest.mark.parametrize("c_out,k,s", CONV_SPECS)
def test_apply_layer_dwsep_conv(c_out, k, s, mode, bn):
    """BN applies only when the spec says so and the params hold its keys
    (BN-folded params drop them): the three cases, in each mode."""
    rng = np.random.default_rng(c_out + k + s)
    jspec, tspec = _conv(c_out, k, s, use_bn=bn != "no_bn_spec")
    p = _conv_params(8, c_out, k, rng, bn=bn != "folded")
    x = rng.normal(size=(3, 61, 8)).astype(np.float32)
    jp, tp = _both(p)
    want = jlayers.apply_layer(jp, jspec, jnp.asarray(x),
                               train=mode == "train")
    np.testing.assert_allclose(_run(tspec, tp, x, mode), np.asarray(want),
                               **F32_TOL)


def test_no_grad_eval_goes_through_the_conv_wrapper(monkeypatch):
    """Under no_grad with train=False the conv is one wrapper call, with
    the ReLU fused when no BN applies and without it otherwise; training
    never calls it."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw["relu"])
        return dwsep_conv1d(*args, **kw)
    monkeypatch.setattr(tlayers, "dwsep_conv1d", spy)
    rng = np.random.default_rng(0)
    _, tspec = _conv(8, 3, 1)
    x = torch.randn(2, 20, 4)
    _, with_bn = _both(_conv_params(4, 8, 3, rng))
    _, folded = _both(_conv_params(4, 8, 3, rng, bn=False))
    with torch.no_grad():
        tlayers.apply_layer(with_bn, tspec, x)
        tlayers.apply_layer(folded, tspec, x)
        tlayers.apply_layer(with_bn, tspec, x, train=True)
    tlayers.apply_layer(with_bn, tspec, x)
    assert calls == [False, True]


@pytest.mark.parametrize("stride", [2, 4, 8, 16])
def test_apply_layer_maxpool_truncates(stride):
    x = np.random.default_rng(stride).normal(size=(2, 37, 5)
                                             ).astype(np.float32)
    jspec = jlayers.LayerSpec(kind="maxpool", stride=stride)
    tspec = tlayers.LayerSpec(kind="maxpool", stride=stride)
    got = np_of(tlayers.apply_layer({}, tspec, torch.from_numpy(x)))
    want = np.asarray(jlayers.apply_layer({}, jspec, jnp.asarray(x)))
    assert got.shape == (2, 37 // stride, 5)
    np.testing.assert_array_equal(got, want)


def test_apply_layer_globalpool_and_dense():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 29, 6)).astype(np.float32)
    gap = tlayers.apply_layer({}, tlayers.LayerSpec(kind="globalpool"),
                              torch.from_numpy(x))
    np.testing.assert_allclose(
        np_of(gap), np.asarray(jlayers.apply_layer(
            {}, jlayers.LayerSpec(kind="globalpool"), jnp.asarray(x))),
        **F32_TOL)
    p = {"w": rng.normal(size=(6, 2)).astype(np.float32),
         "b": rng.normal(size=(2,)).astype(np.float32)}
    jp, tp = _both(p)
    dense = tlayers.apply_layer(tp, tlayers.LayerSpec(kind="dense",
                                                      out_channels=2), gap)
    want = jlayers.apply_layer(jp, jlayers.LayerSpec(kind="dense",
                                                     out_channels=2),
                               jnp.asarray(np_of(gap)))
    np.testing.assert_allclose(np_of(dense), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("kind", ["dwsep_conv", "dense", "maxpool"])
def test_init_layer_shapes_and_scales(kind):
    """Same keys, shapes and dtypes as the reference; He-style scales (the
    draws differ: JAX's threefry cannot be replayed in torch)."""
    kw = dict(out_channels=32, kernel_size=7) if kind == "dwsep_conv" else \
        dict(out_channels=2) if kind == "dense" else dict(stride=4)
    jp = jlayers.init_layer(jax.random.PRNGKey(0),
                            jlayers.LayerSpec(kind=kind, **kw), 32)
    tp = tlayers.init_layer(torch.Generator().manual_seed(0),
                            tlayers.LayerSpec(kind=kind, **kw), 32)
    assert {k: (v.shape, str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).split(".")[1])
         for k, v in tp.items()}
    for k, v in tp.items():
        if k in ("dw", "pw", "w"):
            fan = v.shape[0] if k != "dw" else kw["kernel_size"]
            gain = 1.0 if k == "w" else 2.0
            assert abs(float(v.std()) / (gain / fan) ** 0.5 - 1) < 0.4
        else:
            np.testing.assert_array_equal(np_of(v), np.asarray(jp[k]))
    again = tlayers.init_layer(torch.Generator().manual_seed(0),
                               tlayers.LayerSpec(kind=kind, **kw), 32)
    assert all(torch.equal(tp[k], again[k]) for k in tp)


BITS = [4, 8, 16, 0, 32, -1]


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_int_bits_bit_for_bit(bits, axis):
    x = np.random.default_rng(bits + 7).normal(size=(17, 9)
                                               ).astype(np.float32) * 3
    got = tquant.fake_quant(torch.from_numpy(x), bits, per_channel_axis=axis)
    want = jquant.fake_quant(jnp.asarray(x), bits, per_channel_axis=axis)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_tensor_bits_bit_for_bit(bits):
    """The traced-bits path (a tensor of bit widths, the ``where`` disable
    rule) equals the reference's and the int path."""
    x = np.random.default_rng(bits + 11).normal(size=(4, 13, 3)
                                                ).astype(np.float32)
    got = tquant.fake_quant(torch.from_numpy(x), torch.tensor(bits),
                            per_channel_axis=2)
    want = jquant.fake_quant(jnp.asarray(x), jnp.asarray(bits),
                             per_channel_axis=2)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    np.testing.assert_array_equal(
        np_of(got), np_of(tquant.fake_quant(torch.from_numpy(x), bits,
                                            per_channel_axis=2)))


@pytest.mark.parametrize("bits", [8, "tensor8", 0])
def test_fake_quant_gradient_is_straight_through(bits):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    b_j = jnp.asarray(8) if bits == "tensor8" else bits
    b_t = torch.tensor(8) if bits == "tensor8" else bits
    want = jax.grad(lambda a: jnp.sum(jquant.fake_quant(a, b_j) ** 2
                                      * jnp.asarray(w)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tquant.fake_quant(xt, b_t) ** 2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(np_of(xt.grad), np.asarray(want), **F32_TOL)


def test_quantize_fold_and_fold_model():
    rng = np.random.default_rng(5)
    jspec, tspec = _conv(16, 5, 2)
    p = _conv_params(8, 16, 5, rng)
    jp, tp = _both(p)
    qcfg = (jquant.QuantConfig(4, 8, 16), tquant.QuantConfig(4, 8, 16))
    assert qcfg[0].short() == qcfg[1].short() == "w4a8i16"
    jq = jquant.quantize_layer_params(jp, jspec, qcfg[0])
    tq = tquant.quantize_layer_params(tp, tspec, qcfg[1])
    for k in jq:
        np.testing.assert_array_equal(np_of(tq[k]), np.asarray(jq[k]))
    jf, tf = jquant.fold_batchnorm(jp, jspec), tquant.fold_batchnorm(tp, tspec)
    assert sorted(tf) == sorted(jf) == ["b", "dw", "pw"]
    for k in jf:
        np.testing.assert_allclose(np_of(tf[k]), np.asarray(jf[k]),
                                   **F32_TOL)
    x = rng.normal(size=(2, 40, 8)).astype(np.float32)
    with torch.no_grad():        # folded == BN with running stats
        np.testing.assert_allclose(
            np_of(tlayers.apply_layer(tf, tspec, torch.from_numpy(x))),
            np_of(tlayers.apply_layer(tp, tspec, torch.from_numpy(x))),
            rtol=1e-5, atol=1e-5)
    pool = tlayers.LayerSpec(kind="maxpool", stride=2)
    folded = tquant.fold_model([tp, {}], [tspec, pool])
    assert folded[1] == {} and sorted(folded[0]) == ["b", "dw", "pw"]
