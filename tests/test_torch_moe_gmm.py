"""Port grouped matmul vs the reference (CPU): the plain version and the
wrapper's CPU path against the reference's Pallas kernel (interpret mode,
with the small blocks its own tests use) and its oracle, ragged sizes no
block divides, and the wrapper's refusals.

Tolerances are the reference's own (tests/test_kernels.py): 1e-4 in f32
(both sides accumulate in f32, in different orders) and 5e-2 in bf16 (the
single output rounding can land on either side).  The CUDA kernel needs
the card; its on-card checks are in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import gmm as jax_gmm
from repro.kernels.moe_gmm.ref import gmm_ref as jax_gmm_ref
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from torch_parity import np_of

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(e, c, d, f, dtype, seed=0):
    """Same numbers on both sides: f32 from numpy, each side rounding to
    bf16 to nearest even where asked."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return ((torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)),
            (jnp.asarray(x, jdt), jnp.asarray(w, jdt)))


def _close(got, want, dtype):
    np.testing.assert_allclose(np_of(got.float()), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("e,c,d,f", [(4, 32, 64, 48), (8, 16, 128, 64),
                                     (2, 64, 32, 32)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_and_cpu_path_match_reference(e, c, d, f, dtype):
    """tests/test_kernels.py's shapes: the port's plain version and the
    wrapper's CPU path against the reference's kernel and oracle."""
    (tx, tw), (jx, jw) = _inputs(e, c, d, f, dtype)
    want_kernel = jax_gmm(jx, jw, interpret=True, block_c=16, block_f=16,
                          block_d=32)
    want_ref = jax_gmm_ref(jx, jw)
    before = gmm.launches
    for got in (gmm_ref(tx, tw), gmm(tx, tw)):
        assert got.dtype == tx.dtype and tuple(got.shape) == (e, c, f)
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)
    assert gmm.launches == before          # the CPU path launches nothing


@pytest.mark.parametrize("e,c,d,f", [(3, 1, 100, 72), (2, 3, 17, 5),
                                     (1, 17, 100, 72), (5, 8, 6, 130)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_sizes_match_einsum(e, c, d, f, dtype):
    """Sizes no tile divides: the wrapper takes them (the reference's
    Pallas kernel wants block multiples); held against an f64 einsum."""
    (tx, tw), _ = _inputs(e, c, d, f, dtype, seed=1)
    want = torch.einsum("ecd,edf->ecf", tx.double(), tw.double())
    got = gmm(tx, tw)
    assert got.dtype == tx.dtype
    _close(got, np_of(want.to(tx.dtype).float()), dtype)


REFUSALS = {
    "rank": (lambda x, w: (x[0], w), "ranks"),
    "experts": (lambda x, w: (x, w[:1].contiguous()), "equal E and D"),
    "depth": (lambda x, w: (x, w[:, :-1].contiguous()), "equal E and D"),
    "mixed_dtypes": (lambda x, w: (x, w.to(torch.bfloat16)), "dtypes"),
    "float16": (lambda x, w: (x.half(), w.half()), "dtypes"),
    "float64": (lambda x, w: (x.double(), w.double()), "dtypes"),
    "non_contiguous": (lambda x, w: (x.transpose(1, 2).contiguous()
                                     .transpose(1, 2), w), "contiguous"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    make, match = REFUSALS[case]
    (x, w), _ = _inputs(2, 4, 8, 6, "float32")
    with pytest.raises(ValueError, match=match):
        gmm(*make(x, w))
