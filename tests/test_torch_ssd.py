"""The port's Mamba-2 SSD scan vs the JAX reference on the CPU, same inputs.

``repro_torch.kernels.ssd.ssd_chunked`` (the plain version, the wrapper's
CPU path and the CUDA kernel's oracle) is held against ``repro``'s
``ssd_chunked`` (y and final state) at f32 1e-5, against its Pallas kernel
in interpret mode (y) and its naive recurrence ``ssd_ref`` at 1e-4, the
reference's own tolerance between those (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd_pallas
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_decode_step as jax_ssd_decode_step
from repro_torch.kernels.ssd import ssd_chunked, ssd_ref, ssd_scan
from repro_torch.models.mamba2 import ssd_decode_step
from torch_parity import F32_TOL, np_of, one_thread  # noqa: F401 (a fixture)

REF_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, length, h, p, g, n, seed=0, dt_hi=0.1):
    """x, dt, a_neg, B, C as numpy f32 (A in [1, 16], as the init draws)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, length, h, p)).astype(np.float32),
            rng.uniform(1e-3, dt_hi, size=(b, length, h)).astype(np.float32),
            -rng.uniform(1, 16, size=(h,)).astype(np.float32),
            rng.normal(size=(b, length, g, n)).astype(np.float32),
            rng.normal(size=(b, length, g, n)).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, L, H, P, G, N, chunk): the reference kernel tests' shapes (G > 1
# among them), a ragged L, and L shorter than the chunk
SHAPES = {
    "ref_g1": (2, 64, 4, 16, 1, 16, 16),
    "ref_g2": (1, 128, 8, 32, 2, 32, 32),
    "ref_g3": (2, 96, 6, 8, 3, 8, 24),
    "ragged": (2, 37, 4, 16, 1, 16, 16),
    "short": (1, 5, 4, 16, 2, 16, 16),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_ssd_matches_reference_chunked_scan(case):
    b, length, h, p, g, n, q = SHAPES[case]
    arrays = _inputs(b, length, h, p, g, n)
    y, state = ssd_chunked(*_torch(arrays), q)
    jy, jstate = jax.jit(jax_ssd_chunked, static_argnums=5)(*_jax(arrays),
                                                             q)
    np.testing.assert_allclose(np_of(y), np_of(jy), **F32_TOL)
    np.testing.assert_allclose(np_of(state), np_of(jstate), **F32_TOL)
    ry, rstate = jax_ssd_ref(*_jax(arrays))
    np.testing.assert_allclose(np_of(y), np_of(ry), **REF_TOL)
    np.testing.assert_allclose(np_of(state), np_of(rstate), **REF_TOL)
    # the port's own oracle is the reference's, step for step
    oy, ostate = ssd_ref(*_torch(arrays))
    np.testing.assert_allclose(np_of(oy), np_of(ry), **F32_TOL)
    np.testing.assert_allclose(np_of(ostate), np_of(rstate), **F32_TOL)


@pytest.mark.parametrize("case", ["ref_g1", "ref_g2", "ref_g3"])
def test_plain_ssd_matches_reference_pallas_kernel(case):
    """The Pallas kernel in interpret mode (L a multiple of the chunk)."""
    b, length, h, p, g, n, q = SHAPES[case]
    arrays = _inputs(b, length, h, p, g, n, seed=1)
    y, _ = ssd_chunked(*_torch(arrays), q)
    got = jax_ssd_pallas(*_jax(arrays), chunk=q, interpret=True)
    np.testing.assert_allclose(np_of(y), np_of(got), **REF_TOL)


def test_plain_ssd_does_not_overflow_on_large_steps():
    """Steps of dt up to 5 at A up to 16: exp(cum[t] - cum[s]) for s > t
    overflows f32 over a 64-step chunk.  The plain version forms no such
    exponent, stays finite, and matches the naive recurrence.  (The
    reference's own chunked scan loses ~1e-4 here to f32 cancellation in
    cum[t] - cum[s]; the port's takes the cumulative decay in f64.)"""
    arrays = _inputs(2, 200, 8, 32, 2, 32, seed=2, dt_hi=5.0)
    cum = np.cumsum(arrays[1][:, :64] * arrays[2], axis=1)
    with np.errstate(over="ignore"):
        assert np.exp(np.float32(cum.max() - cum.min())) == np.inf
    y, state = ssd_chunked(*_torch(arrays), 64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    ry, rstate = jax_ssd_ref(*_jax(arrays))
    np.testing.assert_allclose(np_of(y), np_of(ry), **REF_TOL)
    np.testing.assert_allclose(np_of(state), np_of(rstate), **REF_TOL)


def test_plain_ssd_takes_an_initial_state():
    arrays = _inputs(2, 40, 4, 16, 2, 16, seed=3)
    h0 = np.random.default_rng(4).normal(size=(2, 4, 16, 16)).astype(
        np.float32)
    y, state = ssd_chunked(*_torch(arrays), 16, torch.from_numpy(h0))
    jy, jstate = jax_ssd_chunked(*_jax(arrays), 16, jnp.asarray(h0))
    np.testing.assert_allclose(np_of(y), np_of(jy), **F32_TOL)
    np.testing.assert_allclose(np_of(state), np_of(jstate), **F32_TOL)


def test_bf16_inputs_match_reference():
    """bf16 x/B/C, f32 dt: dt * x is formed in f32 on both sides, so only
    the output's bf16 rounding differs (2e-2, the reference's bf16
    kernel tolerance); the f32 state at 1e-5."""
    arrays = list(_inputs(1, 48, 4, 16, 1, 16, seed=5))
    tx = _torch(arrays)
    jx = _jax(arrays)
    for i in (0, 3, 4):
        tx[i] = tx[i].to(torch.bfloat16)
        jx[i] = jx[i].astype(jnp.bfloat16)
    y, state = ssd_chunked(*tx, 16)
    jy, jstate = jax_ssd_chunked(*jx, 16)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    np.testing.assert_allclose(np_of(y.float()),
                               np.asarray(jy, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np_of(state), np_of(jstate), **F32_TOL)


def test_decode_steps_reproduce_the_sequence():
    """One-token steps from a zero state give the scan's outputs and final
    state (reference tolerance), and each step equals the reference's."""
    b, length, h, p, g, n = 1, 16, 4, 8, 2, 8
    arrays = _inputs(b, length, h, p, g, n, seed=6)
    x, dt, a, bm, cm = _torch(arrays)
    jx, jdt, ja, jbm, jcm = _jax(arrays)
    full, final = ssd_chunked(x, dt, a, bm, cm, 16)
    state = torch.zeros(b, h, n, p)
    jstate = jnp.zeros((b, h, n, p), jnp.float32)
    outs = []
    for t in range(length):
        sl = slice(t, t + 1)
        y, state = ssd_decode_step(x[:, sl], dt[:, sl], a, bm[:, sl],
                                   cm[:, sl], state)
        jy, jstate = jax_ssd_decode_step(jx[:, sl], jdt[:, sl], ja,
                                         jbm[:, sl], jcm[:, sl], jstate)
        np.testing.assert_allclose(np_of(y), np_of(jy), **F32_TOL)
        np.testing.assert_allclose(np_of(state), np_of(jstate), **F32_TOL)
        outs.append(y)
    np.testing.assert_allclose(np_of(torch.cat(outs, 1)), np_of(full),
                               **REF_TOL)
    np.testing.assert_allclose(np_of(state), np_of(final), **REF_TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _torch(_inputs(2, 37, 4, 16, 1, 16, seed=7))
    before = ssd_scan.launches
    y, state = ssd_scan(*args, 16)
    want_y, want_state = ssd_chunked(*args, 16)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("bad,match", [
    ("state_12", "state size 12"),
    ("dt_bf16", "dt and a_neg must be float32"),
    ("b_f32_x_bf16", "dtypes"),
    ("heads_over_groups", "does not match"),
    ("strided", "contiguous"),
    ("empty", "sequence length 0"),
    ("chunk_0", "chunk 0 must be"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """The shape checks run before the device is looked at, so a CUDA
    tensor of the same shape raises the same error."""
    n = 12 if bad == "state_12" else 16
    g = 3 if bad == "heads_over_groups" else 1
    length = 0 if bad == "empty" else 8
    chunk = 0 if bad == "chunk_0" else 16
    x, dt, a, bm, cm = _torch(_inputs(1, length, 4, 16, g, n, seed=8))
    if bad == "dt_bf16":
        dt = dt.to(torch.bfloat16)
    elif bad == "b_f32_x_bf16":
        x = x.to(torch.bfloat16)
    elif bad == "strided":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        ssd_scan(x, dt, a, bm, cm, chunk)


# (B, L, H, P, G, N, dt_hi) of the chunk-length cases: a ragged L over
# several chunks of every length, and steps of dt up to 5
CHUNK_CASES = {
    "ragged": (2, 301, 4, 16, 2, 16, 0.1),
    "large_steps": (1, 200, 4, 16, 2, 16, 5.0),
}


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_plain_ssd_does_not_depend_on_its_chunk(case, chunk):
    """The CUDA kernel picks its own chunk (64 steps) where ``repro`` runs
    256: the plain version at 64, 128 and 256 gives repro's scan.  On the
    ragged case against ``ssd_chunked`` at 256; at large steps against the
    naive recurrence, since repro's chunked scan at 256 steps misses 1e-4
    there by several times (f32 cancellation in cum[t] - cum[s], ROADMAP
    queue 3), which the port's f64 cumulative sums avoid.  Between chunk
    lengths the port agrees at f32 1e-5."""
    b, length, h, p, g, n, dt_hi = CHUNK_CASES[case]
    arrays = _inputs(b, length, h, p, g, n, seed=12, dt_hi=dt_hi)
    y, state = ssd_chunked(*_torch(arrays), chunk)
    if case == "ragged":
        want = jax.jit(jax_ssd_chunked, static_argnums=5)(*_jax(arrays), 256)
    else:
        want = jax_ssd_ref(*_jax(arrays))
    np.testing.assert_allclose(np_of(y), np_of(want[0]), **REF_TOL)
    np.testing.assert_allclose(np_of(state), np_of(want[1]), **REF_TOL)
    y256, state256 = ssd_chunked(*_torch(arrays), 256)
    np.testing.assert_allclose(np_of(y), np_of(y256), **F32_TOL)
    np.testing.assert_allclose(np_of(state), np_of(state256), **F32_TOL)
