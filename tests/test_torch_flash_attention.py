"""The port's flash attention (plain version), causal or not, vs the JAX
reference on the CPU, same inputs.

``repro_torch.kernels.flash_attention.flash_attention_ref`` (the wrapper's
CPU path and the CUDA kernel's oracle) is held against ``repro``'s
``flash_attention_pallas`` in interpret mode and its ``attention_ref``
oracle, at the GQA ratios and head dims the ported models use, with and
without the causal mask and where Sq != Sk: f32 2e-5 and bf16 2e-2, the
reference's own flash tests' tolerances (tests/test_kernels.py).
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


def _qkv(b, s, h, kvh, hd, seed=0, sk=None):
    """q (b, s, h, hd); k and v (b, sk or s, kvh, hd)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s if i == 0 else sk or s, n,
                             hd)).astype(np.float32)
            for i, n in enumerate((h, kvh, kvh))]


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


# (B, Sq, Sk, H, KVH, hd) without a mask: whisper's encoder (MHA 6/6 at
# hd 64) and its cross-attention (a few decoder rows against many frames),
# GQA groups, Sq = 1 (one decode step) and Sq > Sk; the Pallas kernel
# takes whole blocks, so each case's Sq and Sk are its own blocks
FULL_CASES = {
    "encoder_mha_hd64": (2, 40, 40, 6, 6, 64),
    "cross_4_of_48": (2, 4, 48, 6, 6, 64),
    "rep2_hd128": (1, 24, 56, 4, 2, 128),
    "sq1_rep4_hd32": (3, 1, 37, 8, 2, 32),
    "sq_over_sk_hd112": (1, 64, 8, 4, 4, 112),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FULL_CASES))
def test_plain_flash_without_a_mask_matches_reference(case, dtype):
    b, sq, sk, h, kvh, hd = FULL_CASES[case]
    (q, k, v), (jq, jk, jv) = _as(_qkv(b, sq, h, kvh, hd, seed=sq + sk,
                                       sk=sk), dtype)
    got = flash_attention_ref(q, k, v, causal=False)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jax_flash(jq, jk, jv, causal=False, interpret=True,
                       block_q=sq, block_k=sk)
    oracle = attention_ref(jq, jk, jv, causal=False)
    for want in (pallas, oracle):
        np.testing.assert_allclose(np_of(got.float()),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])
    assert torch.equal(flash_attention(q, k, v, causal=False), got)


@pytest.mark.parametrize("sk", [1, 63, 65, 300])
@pytest.mark.parametrize("sq", [1, 4, 37])
def test_plain_flash_without_a_mask_at_ragged_lengths(sq, sk):
    """Any Sq and Sk: against the oracle and against the chunked attention
    the reference's encoder and cross-attention run (chunks of 64, the
    reduced configs' ``attn_chunk``, so Sk 65 and 300 leave a ragged
    chunk)."""
    (q, k, v), (jq, jk, jv) = _as(_qkv(2, sq, 6, 3, 64, seed=sq * sk,
                                       sk=sk), "float32")
    got = np_of(flash_attention_ref(q, k, v, causal=False))
    np.testing.assert_allclose(
        got, np.asarray(attention_ref(jq, jk, jv, causal=False)),
        **TOL["float32"])
    chunked = jax.jit(lambda q_, k_, v_: jax_chunked(q_, k_, v_,
                                                     causal=False, chunk=64))
    np.testing.assert_allclose(got, np.asarray(chunked(jq, jk, jv)),
                               **TOL["float32"])


@pytest.mark.parametrize("sq,sk", [(4, 40), (40, 4), (24, 56), (1, 9)])
def test_plain_flash_causal_with_sq_unlike_sk(sq, sk):
    """causal=True where Sq != Sk takes attention_ref's top-left mask
    (query i sees keys 0..i), as the Pallas kernel does."""
    (q, k, v), (jq, jk, jv) = _as(_qkv(1, sq, 4, 2, 64, seed=sq + 5 * sk,
                                       sk=sk), "float32")
    got = np_of(flash_attention_ref(q, k, v, causal=True))
    np.testing.assert_allclose(
        got, np.asarray(attention_ref(jq, jk, jv, causal=True)),
        **TOL["float32"])
    pallas = jax_flash(jq, jk, jv, causal=True, interpret=True, block_q=sq,
                       block_k=sk)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL["float32"])


def test_plain_flash_without_a_mask_blocks_long_sequences():
    """Queries are taken Q_BLOCK at a time without a mask too: whisper's
    1,500 encoder frames against the oracle."""
    (q, k, v), (jq, jk, jv) = _as(_qkv(1, 1500, 2, 2, 32, sk=1500),
                                  "float32")
    np.testing.assert_allclose(
        np_of(flash_attention_ref(q, k, v, causal=False)),
        np.asarray(attention_ref(jq, jk, jv, causal=False)),
        **TOL["float32"])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    (q, k, v), _ = _as(_qkv(2, 40, 8, 4, 64), "float32")
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_mask))
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       flash_attention_ref(q, k, v, causal=False))
    assert (flash_attention.launches,
            flash_attention.launches_by_mask) == before


@pytest.mark.parametrize("bad,match", [
    ("head_dim_16", "head_dim 16"),
    ("sq_ne_sk", "one shape"),
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
        # Sq != Sk is taken (cross-attention); k and v of unlike Sk are not
        k = torch.zeros(1, 9, 2, hd)
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
