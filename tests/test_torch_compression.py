"""Port gradient compression vs the reference (CPU): the bf16 round trip
and error-feedback top-k, which must conserve mass (sent + residual =
grad + previous residual), on the same numbers in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import CompressionConfig as JaxConfig
from repro.distributed.compression import EFTopK as JaxEFTopK
from repro.distributed.compression import compress_grads as jax_compress
from repro_torch.distributed import CompressionConfig, EFTopK, compress_grads
from torch_parity import np_of


def _grads(seed, n=100):
    g = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)
    return {"w": torch.from_numpy(g.copy())}, {"w": jnp.asarray(g)}


def test_bf16_compression_matches_reference():
    g, jg = _grads(0, 64)
    out = compress_grads(g, CompressionConfig(mode="bf16"))
    want = jax_compress(jg, JaxConfig(mode="bf16"))
    assert out["w"].dtype == torch.float32
    np.testing.assert_array_equal(np_of(out["w"]), np.asarray(want["w"]))
    assert float((out["w"] - g["w"]).abs().max()) < 0.01


def test_none_passes_through_and_topk_mode_is_stateful():
    g, _ = _grads(0, 8)
    assert compress_grads(g, CompressionConfig(mode="none")) is g
    with pytest.raises(ValueError, match="EFTopK"):
        compress_grads(g, CompressionConfig(mode="topk"))


@pytest.mark.parametrize("frac", [0.1, 0.03])
def test_ef_topk_matches_reference_and_conserves_mass(frac):
    g, jg = _grads(1)
    ef, jef = EFTopK(frac=frac), JaxEFTopK(frac=frac)
    res, jres = ef.init(g), jef.init(jg)
    for _ in range(3):
        prev = res["w"].clone()
        sent, res = ef.compress(g, res)
        jsent, jres = jef.compress(jg, jres)
        np.testing.assert_array_equal(np_of(sent["w"]),
                                      np.asarray(jsent["w"]))
        np.testing.assert_allclose(np_of(res["w"]), np.asarray(jres["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np_of(sent["w"] + res["w"]),
                                   np_of(g["w"] + prev), rtol=1e-6)
        assert int((sent["w"] != 0).sum()) <= int(100 * frac) + 5
