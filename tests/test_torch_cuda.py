"""The port's CUDA kernels on the card: held against their plain versions.

Imports torch and the port only, so it runs on a machine with a card and
no JAX:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Without a card every test skips (the fixture decides, at run time).
Tolerances: f32 1e-5 (both sides sum in f32, in different orders); bf16
2e-2 for attention and 3e-2 for the conv (the reference's own kernel
tests' tolerances: the output's single bf16 rounding can land on either
side).  The SSD scan: 1e-4 for y and the state, the reference's own
tolerance between its chunked scan and the step-by-step recurrence
(tests/test_kernels.py), which is what the kernel runs against the
chunked plain version; bf16 y 2e-2, one output rounding.  The grouped
matmul: 1e-4 (f32) and 5e-2 (bf16), the reference's own (its
tests/test_kernels.py), with w scaled by 1/sqrt(D) so outputs are O(1).
"""
import pytest
import torch

from repro_torch.kernels.conv1d import dwsep_conv1d, dwsep_conv1d_ref
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.ssd import ssd_chunked, ssd_scan

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(b, s, kvh, rep, hd, lens, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, kvh * rep, hd, generator=gen)
    k = torch.randn(b, s, kvh, hd, generator=gen)
    v = torch.randn(b, s, kvh, hd, generator=gen)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            torch.tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4, 7, 8])
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_kernel_matches_plain_version(cuda_device, dtype, rep, hd):
    s = 203                     # no multiple of any tile
    lens = [1, s, 37, 128, 129, 64]
    args = _inputs(len(lens), s, 2, rep, hd, lens, dtype, cuda_device)
    before = decode_attention.launches
    got = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               decode_attention_ref(*args).float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_kernel_rows_do_not_depend_on_the_batch(cuda_device):
    """No atomics, order fixed by kv_len: a row alone equals the same row
    inside a batch, bit for bit."""
    lens = [300, 5, 1024, 77]
    q, k, v, kv = _inputs(4, 1024, 8, 4, 128, lens, torch.bfloat16,
                          cuda_device)
    full = decode_attention(q, k, v, kv)
    for b in range(4):
        one = decode_attention(q[b:b + 1].contiguous(),
                               k[b:b + 1].contiguous(),
                               v[b:b + 1].contiguous(), kv[b:b + 1])
        assert torch.equal(one[0], full[b])


@pytest.mark.cuda
def test_engine_decode_runs_the_kernel(cuda_device):
    """Slotted decode on the card launches the kernel once per layer."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build_model
    cfg = reduced_config("qwen3-4b")
    bundle = build_model(cfg)
    params = bundle.init(0, device=cuda_device)
    cache = bundle.make_slot_cache(2, 32, device=cuda_device)
    cache["lens"] += torch.tensor([3, 9], dtype=torch.int32,
                                  device=cuda_device)
    before = decode_attention.launches
    logits, cache = bundle.decode_slotted(params, cache, {
        "tokens": torch.tensor([[1], [2]], dtype=torch.int32,
                               device=cuda_device),
        "active": torch.tensor([True, True], device=cuda_device)})
    torch.cuda.synchronize()
    assert decode_attention.launches == before + cfg.n_layers
    assert torch.isfinite(logits).all()
    assert cache["lens"].tolist() == [4, 10]


def _paged_inputs(lens, nb, bs, kvh, rep, hd, dtype, device, seed=0):
    """A shuffled pool shared out across rows (P = B*NB + 7 pages, some
    never used), sentinel (= P) entries past each row's kv_len."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    b = len(lens)
    p = b * nb + 7
    q = torch.randn(b, kvh * rep, hd, generator=gen)
    kp = torch.randn(p, bs, kvh, hd, generator=gen)
    vp = torch.randn(p, bs, kvh, hd, generator=gen)
    perm = torch.randperm(p, generator=gen)[:b * nb].reshape(b, nb)
    tables = torch.full((b, nb), p, dtype=torch.int32)
    for row, n in enumerate(lens):
        used = min(-(-n // bs), nb)
        tables[row, :used] = perm[row, :used].to(torch.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            tables.to(device), torch.tensor(lens, dtype=torch.int32,
                                            device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4, 7, 8])
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
@pytest.mark.parametrize("bs", [16, 5])
def test_paged_kernel_matches_plain_version(cuda_device, dtype, rep, hd, bs):
    """Shuffled, shared-out pages; kv_len 1, the full span, past the span
    (a finished slot at the boundary), and ending mid-page."""
    nb = 13
    lens = [1, nb * bs, nb * bs + 3, 2 * bs + 1, 5 * bs - 1, 37]
    args = _paged_inputs(lens, nb, bs, 2, rep, hd, dtype, cuda_device)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               paged_decode_attention_ref(*args).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_equals_dense_kernel_on_identity_tables(cuda_device,
                                                             dtype):
    """NB*BS == S and tables[b] = b*NB + arange(NB): the same arithmetic in
    the same order as the dense kernel, so equal bit for bit."""
    lens = [300, 5, 1024, 77, 1, 640]
    b, s, bs = len(lens), 1024, 16
    nb = s // bs
    q, k, v, kv = _inputs(b, s, 8, 4, 128, lens, dtype, cuda_device)
    tables = torch.arange(b * nb, dtype=torch.int32,
                          device=cuda_device).reshape(b, nb)
    paged = paged_decode_attention(q, k.reshape(b * nb, bs, 8, 128),
                                   v.reshape(b * nb, bs, 8, 128), tables, kv)
    assert torch.equal(paged, decode_attention(q, k, v, kv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_equals_dense_kernel_at_head_dim_112(cuda_device,
                                                          dtype):
    """zamba2-7b's shared block (MHA, hd 112, idle lanes past hd): the
    identity-table equality holds there too."""
    lens = [300, 5, 1024, 77]
    b, s, bs = len(lens), 1024, 16
    nb = s // bs
    q, k, v, kv = _inputs(b, s, 32, 1, 112, lens, dtype, cuda_device)
    tables = torch.arange(b * nb, dtype=torch.int32,
                          device=cuda_device).reshape(b, nb)
    paged = paged_decode_attention(q, k.reshape(b * nb, bs, 32, 112),
                                   v.reshape(b * nb, bs, 32, 112), tables, kv)
    assert torch.equal(paged, decode_attention(q, k, v, kv))


@pytest.mark.cuda
def test_paged_kernel_rows_do_not_depend_on_the_batch(cuda_device):
    lens = [300, 5, 1024, 77]
    q, kp, vp, tables, kv = _paged_inputs(lens, 64, 16, 8, 4, 128,
                                          torch.bfloat16, cuda_device)
    full = paged_decode_attention(q, kp, vp, tables, kv)
    for b in range(4):
        one = paged_decode_attention(q[b:b + 1].contiguous(), kp, vp,
                                     tables[b:b + 1].contiguous(),
                                     kv[b:b + 1])
        assert torch.equal(one[0], full[b])


@pytest.mark.cuda
def test_paged_engine_decode_runs_the_paged_kernel(cuda_device):
    """A paged engine on the card launches the paged kernel once per layer
    and decode step, and the dense kernel never."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine, ServeRequest
    cfg = reduced_config("qwen3-4b")
    bundle = build_model(cfg)
    params = bundle.init(0, device=cuda_device)
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new=5)
        for i, n in enumerate([3, 17, 9, 30, 12])]
    engine = ServeEngine(bundle, params, EngineConfig(
        slots=3, cache_len=64, paged=True, block_size=16), device=cuda_device)
    dense_before = decode_attention.launches
    before = paged_decode_attention.launches
    done = engine.run(reqs)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 5 for r in done)
    assert paged_decode_attention.launches - before == \
        engine.decode_steps * cfg.n_layers
    assert decode_attention.launches == dense_before


# the ECG path's conv shapes at the search space's full width (B, L, C_in,
# K, C_out, stride), and the reference kernel tests' edge shapes
CONV_SHAPES = [
    (256, 3750, 2, 7, 32, 1),
    (256, 3744, 32, 7, 32, 1),
    (256, 1867, 32, 5, 32, 2),
    (64, 1875, 16, 3, 8, 4),
    (2, 50, 16, 1, 2, 1),
    (1, 33, 2, 3, 130, 1),
]
CONV_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def _conv_inputs(b, length, c_in, k, c_out, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(device, dtype)
                 for shape in ((b, length, c_in), (k, c_in), (c_in, c_out),
                               (c_out,)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("b,length,c_in,k,c_out,stride", CONV_SHAPES)
def test_conv_kernel_matches_plain_version(cuda_device, b, length, c_in, k,
                                           c_out, stride, relu, dtype):
    args = _conv_inputs(b, length, c_in, k, c_out, dtype, cuda_device)
    before = dwsep_conv1d.launches
    got = dwsep_conv1d(*args, stride=stride, relu=relu)
    torch.cuda.synchronize()
    assert dwsep_conv1d.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, (length - k) // stride + 1,
                                                c_out)
    torch.testing.assert_close(
        got.float(), dwsep_conv1d_ref(*args, stride=stride,
                                      relu=relu).float(), **CONV_TOL[dtype])


@pytest.mark.cuda
def test_conv_kernel_rows_do_not_depend_on_the_batch(cuda_device):
    """No atomics, no cross-record state: a record alone equals the same
    record inside a batch, bit for bit."""
    x, dw, pw, b = _conv_inputs(5, 1867, 32, 5, 32, torch.float32,
                                cuda_device)
    full = dwsep_conv1d(x, dw, pw, b, stride=2)
    for r in range(5):
        one = dwsep_conv1d(x[r:r + 1].contiguous(), dw, pw, b, stride=2)
        assert torch.equal(one[0], full[r])


@pytest.mark.cuda
def test_conv_launches_count_no_grad_layers_only(cuda_device):
    """A no-grad eval forward of a dw-sep conv is one kernel launch, with
    BN running stats or folded; a training forward, or an eval forward with
    grad enabled, runs autograd ops and launches nothing."""
    from repro_torch.hwlib.layers import LayerSpec, apply_layer, init_layer
    from repro_torch.hwlib.quant import fold_batchnorm
    spec = LayerSpec(kind="dwsep_conv", out_channels=32, kernel_size=5,
                     stride=2)
    params = {k: v.to(cuda_device) for k, v in init_layer(
        torch.Generator().manual_seed(0), spec, 16).items()}
    x = torch.randn(4, 300, 16, device=cuda_device)
    before = dwsep_conv1d.launches
    with torch.no_grad():
        bn = apply_layer(params, spec, x)
        folded = apply_layer(fold_batchnorm(params, spec), spec, x)
    assert dwsep_conv1d.launches == before + 2
    torch.testing.assert_close(bn, folded, rtol=1e-5, atol=1e-5)
    apply_layer(params, spec, x, train=True)
    apply_layer(params, spec, x)
    with torch.no_grad():
        apply_layer(params, spec, x, train=True)
    assert dwsep_conv1d.launches == before + 2


# ------------------------------------------------------------ SSD scan
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# (B, L, H, P, G, N): zamba2-7b and mamba2-780m at full width, ragged and
# tiny L, and the reference kernel tests' shapes (G > 1)
SSD_SHAPES = [
    (1, 700, 112, 64, 1, 64),
    (2, 256, 112, 64, 1, 64),
    (1, 300, 48, 64, 1, 128),
    (3, 1, 112, 64, 1, 64),
    (1, 3, 48, 64, 1, 128),
    (2, 64, 4, 16, 1, 16),
    (1, 128, 8, 32, 2, 32),
    (2, 96, 6, 8, 3, 8),
]


def _ssd_inputs(b, length, h, p, g, n, dtype, device, seed=0, dt_hi=0.1):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, length, h, p, generator=gen)
    dt = 1e-3 + (dt_hi - 1e-3) * torch.rand(b, length, h, generator=gen)
    a_neg = -(1.0 + 15.0 * torch.rand(h, generator=gen))
    bm = torch.randn(b, length, g, n, generator=gen)
    cm = torch.randn(b, length, g, n, generator=gen)
    return (x.to(device, dtype), dt.to(device), a_neg.to(device),
            bm.to(device, dtype), cm.to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,length,h,p,g,n", SSD_SHAPES)
def test_ssd_kernel_matches_plain_version(cuda_device, b, length, h, p, g,
                                          n, dtype):
    args = _ssd_inputs(b, length, h, p, g, n, dtype, cuda_device)
    before = ssd_scan.launches
    y, state = ssd_scan(*args, 256)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_state = ssd_chunked(*args, 256)
    assert y.dtype == dtype and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(state, want_state, **SSD_TOL[torch.float32])


@pytest.mark.cuda
def test_ssd_kernel_takes_large_steps(cuda_device):
    """Steps whose chunk-wide decay would overflow exp in the chunked
    form's s > t half: finite and equal to the plain version."""
    args = _ssd_inputs(2, 200, 8, 32, 2, 32, torch.float32, cuda_device,
                       dt_hi=5.0)
    y, state = ssd_scan(*args, 64)
    want_y, want_state = ssd_chunked(*args, 64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y, want_y, **SSD_TOL[torch.float32])
    torch.testing.assert_close(state, want_state, **SSD_TOL[torch.float32])


@pytest.mark.cuda
def test_ssd_kernel_rows_do_not_depend_on_the_batch(cuda_device):
    args = _ssd_inputs(3, 300, 16, 64, 1, 64, torch.bfloat16, cuda_device)
    y, state = ssd_scan(*args, 256)
    for r in range(3):
        one = [t[r:r + 1].contiguous() if t.dim() > 1 else t for t in args]
        y1, s1 = ssd_scan(*one, 256)
        assert torch.equal(y1[0], y[r]) and torch.equal(s1[0], state[r])


@pytest.mark.cuda
def test_ssd_and_flash_refuse_what_the_kernels_do_not_take(cuda_device):
    args = list(_ssd_inputs(1, 8, 4, 16, 1, 12, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="state size 12"):
        ssd_scan(*args, 256)
    q = torch.zeros(1, 8, 4, 16, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 16"):
        flash_attention(q, q, q)


# ------------------------------------------------------- flash attention
# (B, S, H, KVH, hd): qwen3-4b, qwen2-0.5b (rep 7) and zamba2-7b prefill
# widths, ragged S, and the reduced configs' hd 32
FLASH_SHAPES = [
    (1, 704, 32, 8, 128),
    (2, 40, 14, 2, 64),
    (1, 700, 32, 32, 112),
    (3, 1, 32, 32, 112),
    (2, 65, 8, 4, 32),
    (1, 200, 4, 1, 64),
    (1, 129, 6, 3, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kvh,hd", FLASH_SHAPES)
def test_flash_kernel_matches_plain_version(cuda_device, b, s, h, kvh, hd,
                                            dtype):
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).to(cuda_device, dtype)
               for n in (h, kvh, kvh))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-780m"])
def test_hybrid_engine_runs_every_kernel(cuda_device, arch):
    """The reduced hybrid on the card, dense and paged: SSD launches =
    Mamba layers x prefill calls, flash = shared-block applications x
    prefill calls, decode = applications x decode steps, and the paged
    tokens equal the dense ones."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models.hybrid import _layout
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine, ServeRequest
    cfg = reduced_config(arch, dtype="bfloat16")
    n_groups = _layout(cfg)[0]
    bundle = build_model(cfg)
    params = bundle.init(0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in [3, 17, 9, 30, 12]]
    tokens = []
    for paged in (False, True):
        engine = ServeEngine(bundle, params, EngineConfig(
            slots=3, cache_len=64, pad_to=1, paged=paged, block_size=16),
            device=cuda_device)
        counts = [ssd_scan.launches, flash_attention.launches,
                  decode_attention.launches, paged_decode_attention.launches]
        done = engine.run([ServeRequest(rid=i, prompt=p, max_new=5)
                           for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        ssd, flash, dense, pag = (now - was for now, was in zip(
            [ssd_scan.launches, flash_attention.launches,
             decode_attention.launches, paged_decode_attention.launches],
            counts))
        assert all(r.done and len(r.out) == 5 for r in done)
        assert ssd == engine.prefill_calls * cfg.n_layers
        assert flash == engine.prefill_calls * n_groups
        assert (pag if paged else dense) == engine.decode_steps * n_groups
        assert (dense if paged else pag) == 0
        tokens.append([r.out for r in done])
    assert tokens[0] == tokens[1]


# (E, C, D, F): the reference tests' shapes, ragged sizes no tile divides
# (C 1, 3, 17; D 100, 6; F 72, 130: the plain-load path), the tile edges of
# both bf16 tile shapes (C 16 and 17, 64 and 65), and the reduced configs'
# D 128 and F 64
GMM_SHAPES = [(4, 32, 64, 48), (8, 16, 128, 64), (2, 64, 32, 32),
              (3, 1, 100, 72), (2, 3, 100, 72), (2, 17, 100, 72),
              (5, 8, 6, 130), (2, 16, 256, 136), (2, 65, 96, 256),
              (8, 8, 128, 64), (8, 40, 64, 128)]
GMM_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


def _gmm_inputs(e, c, d, f, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(e, c, d, generator=gen)
    w = torch.randn(e, d, f, generator=gen) / d ** 0.5
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_gmm_kernel_matches_plain_version(cuda_device, e, c, d, f, dtype):
    x, w = _gmm_inputs(e, c, d, f, dtype, cuda_device)
    before = gmm.launches
    got = gmm(x, w)
    torch.cuda.synchronize()
    assert gmm.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (e, c, f)
    torch.testing.assert_close(got.float(), gmm_ref(x, w).float(),
                               **GMM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,f", [(8, 6144, 10752), (8, 10752, 6144)],
                         ids=["gate_up", "down"])
def test_gmm_kernel_at_dbrx_decode_shapes(cuda_device, c, d, f):
    """dbrx-132b's 16 experts at decode (cap 8), bf16, the main path's
    type; also normwise within one output rounding."""
    x, w = _gmm_inputs(16, c, d, f, torch.bfloat16, cuda_device)
    got, want = gmm(x, w), gmm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **GMM_TOL[torch.bfloat16])
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel < 1e-2


@pytest.mark.cuda
def test_gmm_kernel_is_deterministic_and_experts_independent(cuda_device):
    """No atomics: the same call twice is bit for bit the same, and an
    expert's rows alone equal the same rows inside the whole call."""
    x, w = _gmm_inputs(6, 40, 256, 200, torch.bfloat16, cuda_device)
    full = gmm(x, w)
    assert torch.equal(full, gmm(x, w))
    for e in (0, 5):
        one = gmm(x[e:e + 1].contiguous(), w[e:e + 1].contiguous())
        assert torch.equal(one[0], full[e])


@pytest.mark.cuda
def test_gmm_refuses_what_the_kernel_does_not_take(cuda_device):
    x, w = _gmm_inputs(2, 4, 8, 6, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        gmm(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        gmm(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="device"):
        gmm(x, w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_engine_runs_every_kernel(cuda_device, arch):
    """The reduced MoE LM on the card, dense and paged: gmm launches = 3 x
    layers x (prefill calls + decode steps), flash = layers x prefill
    calls, decode = layers x decode steps, paged tokens equal dense tokens
    (same buckets, so the same pairs drop), and a run repeats its tokens
    exactly (no atomics in dispatch or combine)."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine, ServeRequest
    cfg = reduced_config(arch, dtype="bfloat16")
    n = cfg.n_layers
    bundle = build_model(cfg)
    params = bundle.init(0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, k).astype(np.int32)
               for k in [3, 17, 9, 30, 12]]
    tokens = []
    for paged in (False, True, True):
        engine = ServeEngine(bundle, params, EngineConfig(
            slots=3, cache_len=64, pad_to=8, paged=paged, block_size=16),
            device=cuda_device)
        before = [gmm.launches, flash_attention.launches,
                  decode_attention.launches, paged_decode_attention.launches]
        done = engine.run([ServeRequest(rid=i, prompt=p, max_new=5)
                           for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        moe, flash, dense, pag = (now - was for now, was in zip(
            [gmm.launches, flash_attention.launches,
             decode_attention.launches, paged_decode_attention.launches],
            before))
        assert all(r.done and len(r.out) == 5 for r in done)
        assert moe == 3 * n * (engine.prefill_calls + engine.decode_steps)
        assert flash == engine.prefill_calls * n
        assert (pag if paged else dense) == engine.decode_steps * n
        assert (dense if paged else pag) == 0
        tokens.append([r.out for r in done])
    assert tokens[0] == tokens[1] == tokens[2]


@pytest.mark.cuda
def test_moe_block_runs_without_a_host_sync(cuda_device):
    """Dispatch, the three kernel launches and the combine queue on the
    stream without waiting for the card (``cap`` is a Python int from the
    token count); the block repeats its output bit for bit."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.moe import init_moe, moe_block
    cfg = reduced_config("dbrx-132b", dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn(2, 24, cfg.d_model, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    moe_block(p, x, cfg)                  # first call: build, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe_block(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again, _ = moe_block(p, x, cfg)
    assert torch.equal(y, again)
