"""The port's causal flash attention (plain version) vs the JAX reference
on the CPU, same inputs.

``repro_torch.kernels.flash_attention.flash_attention_ref`` (the wrapper's
CPU path and the CUDA kernel's oracle) is held against ``repro``'s
``flash_attention_pallas`` in interpret mode and its ``attention_ref``
oracle, at the GQA ratios and head dims the ported models use: f32 2e-5
and bf16 2e-2, the reference's own flash tests' tolerances
(tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)
from torch_parity import np_of, one_thread  # noqa: F401 (a fixture)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(b, s, h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (h, kvh, kvh)]


def _as(arrays, dtype):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return t, j


# (B, S, H, KVH, hd): GQA ratios 1, 2, 4 and 7 (qwen2-0.5b's), head dims
# 64, 112 (zamba2-7b's) and 128 (qwen3-4b's); S a multiple of the Pallas
# kernel's 32-row blocks
PALLAS_CASES = {
    "rep1_hd112": (1, 64, 4, 4, 112),
    "rep2_hd64": (2, 32, 4, 2, 64),
    "rep4_hd128": (1, 64, 8, 2, 128),
    "rep7_hd64": (1, 32, 14, 2, 64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_flash_matches_reference_kernel_and_oracle(case, dtype):
    arrays = _qkv(*PALLAS_CASES[case])
    (q, k, v), (jq, jk, jv) = _as(arrays, dtype)
    got = flash_attention_ref(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jax_flash(jq, jk, jv, causal=True, interpret=True, block_q=32,
                       block_k=32)
    oracle = attention_ref(jq, jk, jv, causal=True)
    for want in (pallas, oracle):
        np.testing.assert_allclose(np_of(got.float()),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("s", [1, 13, 37])
@pytest.mark.parametrize("hd", [64, 112, 128])
def test_plain_flash_at_ragged_lengths(s, hd):
    """Any S (the kernel masks its ragged last tile): against the oracle
    and against the chunked attention the reference's prefill runs."""
    (q, k, v), (jq, jk, jv) = _as(_qkv(2, s, 14, 2, hd, seed=s), "float32")
    got = np_of(flash_attention_ref(q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(attention_ref(jq, jk, jv, causal=True)),
        **TOL["float32"])
    chunked = jax.jit(lambda q_, k_, v_: jax_chunked(q_, k_, v_, causal=True,
                                                     chunk=8))
    np.testing.assert_allclose(got, np.asarray(chunked(jq, jk, jv)),
                               **TOL["float32"])


def test_plain_flash_blocks_long_sequences():
    """Queries are taken Q_BLOCK at a time: a sequence over one block
    equals the oracle too."""
    from repro_torch.kernels.flash_attention import ref
    (q, k, v), (jq, jk, jv) = _as(_qkv(1, ref.Q_BLOCK + 40, 2, 1, 32),
                                  "float32")
    np.testing.assert_allclose(
        np_of(flash_attention_ref(q, k, v)),
        np.asarray(attention_ref(jq, jk, jv, causal=True)), **TOL["float32"])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    (q, k, v), _ = _as(_qkv(2, 40, 8, 4, 64), "float32")
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    assert flash_attention.launches == before


@pytest.mark.parametrize("bad,match", [
    ("head_dim_16", "head_dim 16"),
    ("sq_ne_sk", "does not match"),
    ("gqa", "does not match"),
    ("dtypes", "dtypes"),
    ("strided", "contiguous"),
    ("misaligned_bf16", "16-byte boundary"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """The checks run before the device is looked at, so a CUDA tensor of
    the same shape raises the same error."""
    hd = 16 if bad == "head_dim_16" else 64
    q = torch.zeros(1, 8, 6, hd)
    k = v = torch.zeros(1, 8, 4 if bad == "gqa" else 2, hd)
    if bad == "sq_ne_sk":
        k = v = torch.zeros(1, 9, 2, hd)
    elif bad == "dtypes":
        k = k.to(torch.bfloat16)
        v = v.to(torch.bfloat16)
    elif bad == "strided":
        q = torch.zeros(1, 6, 8, hd).transpose(1, 2)
    elif bad == "misaligned_bf16":
        # contiguous, but one element past an aligned base: TMA cannot
        # take it, and the tensor-core kernel has no other way in
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
        k = v = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v)
