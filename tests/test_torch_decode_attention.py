"""Port decode attention vs the reference's Pallas kernel and oracle (CPU).

The reference's Pallas kernel runs in interpret mode here, as its own
tests run it off-TPU.  The port's CUDA kernel needs the card; its on-card
checks are in tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_op
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
)
from repro_torch.kernels.decode_attention.ops import (
    HEAD_DIMS,
    MAX_TABLE_BLOCKS,
)
from torch_parity import F32_TOL, np_of


def _inputs(b, s, kvh, rep, hd, lens, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh * rep, hd)).astype(dtype)
    k = rng.normal(size=(b, s, kvh, hd)).astype(dtype)
    v = rng.normal(size=(b, s, kvh, hd)).astype(dtype)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_version_matches_reference_kernel_and_oracle(rep, hd):
    """kv_len edge cases: 1, S, and lengths that are no multiple of any
    tile."""
    s = 40
    q, k, v, lens = _inputs(4, s, 2, rep, hd, [1, s, 5, 17])
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, lens)))
    args = tuple(map(jnp.asarray, (q, k, v, lens)))
    np.testing.assert_allclose(np_of(got), np.asarray(jax_ref(*args)),
                               **F32_TOL)
    np.testing.assert_allclose(
        np_of(got), np.asarray(jax_op(*args, impl="pallas", interpret=True,
                                      block_k=8)), **F32_TOL)


def test_plain_version_bf16_matches_oracle():
    """bf16 in and out, f32 inside: equal to the oracle up to one bf16
    rounding of the output."""
    import ml_dtypes
    q, k, v, lens = _inputs(3, 24, 2, 4, 64, [24, 9, 1])
    got = decode_attention_ref(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)), torch.from_numpy(lens))
    want = jax_ref(*(jnp.asarray(a.astype(ml_dtypes.bfloat16))
                     for a in (q, k, v)), jnp.asarray(lens))
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    q, k, v, lens = map(torch.from_numpy, _inputs(2, 16, 2, 4, 32, [3, 16]))
    before = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    assert torch.equal(out, decode_attention_ref(q, k, v, lens))
    assert decode_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep,kvh", [(12, 2), (48, 1)],
                         ids=["rep12", "rep48"])
def test_wide_gqa_groups_match_reference_kernel(rep, kvh, dtype):
    """GQA ratios past 8 (mistral-large-123b's 12, granite-34b's 48 over
    one KV head) at hd 128: the port's wrapper on the CPU against the
    reference's Pallas kernel in interpret mode; f32 to F32_TOL, bf16 to
    one bf16 rounding of the output (2e-2, as above)."""
    import ml_dtypes
    s = 40
    q, k, v, lens = _inputs(3, s, kvh, rep, 128, [1, s, 17])
    if dtype == "bfloat16":
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    got = decode_attention(*(torch.from_numpy(a.astype(np.float32))
                             .to(getattr(torch, dtype)) for a in (q, k, v)),
                           torch.from_numpy(lens))
    want = jax_op(*map(jnp.asarray, (q, k, v, lens)), impl="pallas",
                  interpret=True, block_k=8)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    assert got.shape == (3, kvh * rep, 128)
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want).astype(np.float32), **tol)


def test_wrapper_takes_gqa_ratios_past_8():
    """The kernel holds a whole GQA group in one cluster, so the wrapper
    takes any ratio; rows of one group still read one KV head."""
    q, k, v, lens = map(torch.from_numpy, _inputs(2, 8, 1, 9, 32, [3, 8]))
    out = decode_attention(q, k, v, lens)
    assert out.shape == (2, 9, 32)
    for r in range(9):   # each row alone is the same attention
        one = decode_attention(q[:, r:r + 1].contiguous(), k, v, lens)
        torch.testing.assert_close(out[:, r:r + 1], one, **F32_TOL)


BAD_INPUTS = {
    "hd_unsupported": dict(hd=48),
    "kv_len_int64": dict(lens_dtype=torch.int64),
    "dtype_mismatch": dict(k_dtype=torch.bfloat16),
    "float16": dict(dtype=torch.float16),
    "not_contiguous": dict(strided=True),
    "heads_not_a_multiple_of_kv_heads": dict(kvh=2, q_heads=3),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    opt = BAD_INPUTS[case]
    hd = opt.get("hd", 32)
    q, k, v, lens = map(torch.from_numpy,
                        _inputs(2, 8, opt.get("kvh", 1), 2, hd, [3, 8]))
    if "q_heads" in opt:
        q = q[:, :opt["q_heads"]].contiguous()
    dtype = opt.get("dtype", torch.float32)
    q, k, v = q.to(dtype), k.to(opt.get("k_dtype", dtype)), v.to(dtype)
    lens = lens.to(opt.get("lens_dtype", torch.int32))
    if opt.get("strided"):
        k, v = torch.cat([k, k], 1)[:, ::2], torch.cat([v, v], 1)[:, ::2]
    with pytest.raises(ValueError):
        decode_attention(q, k, v, lens)


def test_wrapper_limits_match_the_cuda_source():
    """The wrapper refuses what the kernel would refuse: its head dims are
    the cases of the source's head-dim switch, and its table limit is the
    source's kMaxTableBlocks (the C entry point's own check)."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "decode_attention.cu").read_text()
    limit = re.search(r"constexpr int kMaxTableBlocks = (\d+);", src)
    assert limit and int(limit.group(1)) == MAX_TABLE_BLOCKS
    switch = re.search(r"switch \(hd\) \{(.*?)default:", src, re.S)
    assert switch
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", switch.group(1)))
    assert cases == HEAD_DIMS
