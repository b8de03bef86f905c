"""Port dwsep conv1d vs the reference's Pallas kernel and oracle (CPU).

The reference's Pallas kernel runs in interpret mode here, as its own
tests run it off-TPU (tests/test_kernels.py:24-43, with its shapes and
tolerances: f32 1e-5, the two sides sum the pointwise product in
different orders, the port's plain version in f64; bf16 3e-2, one bf16
rounding of the output).  The port's CUDA kernel
needs the card; its on-card checks are in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.conv1d.ops import dwsep_conv1d as jax_op
from repro.kernels.conv1d.ref import dwsep_conv1d_ref as jax_ref
from repro_torch.kernels.conv1d import dwsep_conv1d, dwsep_conv1d_ref
from torch_parity import F32_TOL, np_of

SHAPES = [                      # B, L, C_in, K, C_out, stride
    (2, 64, 2, 5, 8, 1),
    (1, 200, 8, 3, 16, 2),
    (3, 97, 4, 7, 32, 4),
    (2, 50, 16, 1, 2, 1),
    (1, 33, 2, 3, 130, 1),
]


def _inputs(b, length, c_in, k, c_out, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, length, c_in)).astype(np.float32),
            rng.normal(size=(k, c_in)).astype(np.float32),
            rng.normal(size=(c_in, c_out)).astype(np.float32),
            rng.normal(size=(c_out,)).astype(np.float32))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("b,length,c_in,k,c_out,stride", SHAPES)
def test_plain_version_matches_reference_kernel_and_oracle(
        b, length, c_in, k, c_out, stride, relu):
    args = _inputs(b, length, c_in, k, c_out)
    got = np_of(dwsep_conv1d_ref(*map(torch.from_numpy, args),
                                 stride=stride, relu=relu))
    jargs = tuple(map(jnp.asarray, args))
    np.testing.assert_allclose(
        got, np.asarray(jax_ref(*jargs, stride=stride, relu=relu)),
        **F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_op(*jargs, stride=stride, relu=relu,
                               interpret=True)), **F32_TOL)


@pytest.mark.parametrize("b,length,c_in,k,c_out,stride", SHAPES)
def test_plain_version_bf16_matches_reference_kernel(
        b, length, c_in, k, c_out, stride):
    args = [a.astype(ml_dtypes.bfloat16)
            for a in _inputs(b, length, c_in, k, c_out, seed=1)]
    got = dwsep_conv1d_ref(*(torch.from_numpy(a.view(np.uint16).copy())
                             .view(torch.bfloat16) for a in args),
                           stride=stride)
    assert got.dtype == torch.bfloat16
    want = jax_op(*map(jnp.asarray, args), stride=stride, interpret=True)
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want).astype(np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_every_kernel_size_and_stride_of_the_search_space(k, stride):
    """The reference's hypothesis sweep as a fixed grid: L 64, C_in 8,
    C_out 32, at f32 1e-5."""
    args = _inputs(2, 64, 8, k, 32, seed=10 * k + stride)
    got = dwsep_conv1d(*map(torch.from_numpy, args), stride=stride)
    want = jax_op(*map(jnp.asarray, args), stride=stride, interpret=True)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    args = tuple(map(torch.from_numpy, _inputs(2, 40, 4, 3, 8)))
    before = dwsep_conv1d.launches
    out = dwsep_conv1d(*args, stride=2, relu=False)
    assert torch.equal(out, dwsep_conv1d_ref(*args, stride=2, relu=False))
    assert out.shape == (2, 19, 8)
    assert dwsep_conv1d.launches == before


BAD_INPUTS = {
    "rank": dict(x_shape=(40, 4)),
    "channels": dict(dw_shape=(3, 5)),
    "bias": dict(b_shape=(7,)),
    "kernel_size_2": dict(dw_shape=(2, 4)),
    "stride_3": dict(stride=3),
    "c_in_over_32": dict(c_in=33),
    "c_out_over_1024": dict(c_out=1025),
    "shorter_than_kernel": dict(length=2),
    "float16": dict(dtype=torch.float16),
    "dtype_mismatch": dict(pw_dtype=torch.bfloat16),
    "not_contiguous": dict(strided=True),
    "meta_device": dict(device="meta"),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    opt = BAD_INPUTS[case]
    c_in, c_out = opt.get("c_in", 4), opt.get("c_out", 8)
    dtype = opt.get("dtype", torch.float32)
    dev = opt.get("device", "cpu")
    x = torch.randn(opt.get("x_shape", (2, opt.get("length", 40), c_in)),
                    dtype=dtype, device=dev)
    dw = torch.randn(opt.get("dw_shape", (3, c_in)), dtype=dtype, device=dev)
    pw = torch.randn((c_in, c_out), device=dev).to(opt.get("pw_dtype", dtype))
    b = torch.randn(opt.get("b_shape", (c_out,)), dtype=dtype, device=dev)
    if opt.get("strided"):
        x = torch.cat([x, x], 1)[:, ::2]
    with pytest.raises(ValueError):
        dwsep_conv1d(x, dw, pw, b, stride=opt.get("stride", 1))
