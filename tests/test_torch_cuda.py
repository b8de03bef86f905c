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


# (H, KVH, hd) of GQA groups wider than 8 heads: granite-34b (MQA, 48 over
# 1) and mistral-large-123b (96 over 8, ratio 12); the kernel holds all of
# a group's rows in one cluster
WIDE_GQA = [(48, 1, 128), (96, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kvh,hd", WIDE_GQA, ids=["granite", "mistral"])
def test_decode_kernels_take_wide_gqa_groups(cuda_device, h, kvh, hd, dtype):
    """Dense and paged kernels at GQA ratios 48 and 12 against their plain
    versions, mixed kv_len; on identity tables the paged kernel still
    equals the dense one bit for bit."""
    lens = [1, 1024, 37, 400, 129, 1000]
    b, s, bs = len(lens), 1024, 16
    nb = s // bs
    q, k, v, kv = _inputs(b, s, kvh, h // kvh, hd, lens, dtype, cuda_device)
    dense = decode_attention(q, k, v, kv)
    torch.testing.assert_close(dense.float(),
                               decode_attention_ref(q, k, v, kv).float(),
                               **TOL[dtype])
    args = _paged_inputs(lens, nb, bs, kvh, h // kvh, hd, dtype, cuda_device)
    torch.testing.assert_close(paged_decode_attention(*args).float(),
                               paged_decode_attention_ref(*args).float(),
                               **TOL[dtype])
    tables = torch.arange(b * nb, dtype=torch.int32,
                          device=cuda_device).reshape(b, nb)
    paged = paged_decode_attention(q, k.reshape(b * nb, bs, kvh, hd),
                                   v.reshape(b * nb, bs, kvh, hd), tables, kv)
    assert torch.equal(paged, dense)


# The decode kernel's split (csrc/decode_attention.cu): tiles of 32
# positions, a row's positions shared out over a cluster of 8 blocks in
# whole tiles, so at S 1024 a block's share is 32 positions up to kv_len
# 256 and 64 from 257.  kv_len 1, one short of a tile, a tile, one past,
# the share's edges, one short of S, and S.
SPLIT_EDGES = [1, 31, 32, 33, 255, 256, 257, 511, 512, 513, 1023, 1024]


def _identity_paged(k, v, bs):
    """k/v (B, S, KVH, hd) as a pool of B*S/BS pages and identity tables."""
    b, s, kvh, hd = k.shape
    nb = s // bs
    tables = torch.arange(b * nb, dtype=torch.int32,
                          device=k.device).reshape(b, nb)
    return (k.reshape(b * nb, bs, kvh, hd), v.reshape(b * nb, bs, kvh, hd),
            tables)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bs", [16, 5])
def test_decode_kernels_at_the_split_edges(cuda_device, dtype, bs):
    """Both entry points against their plain versions at every kv_len
    where a block's share or a tile begins or ends; paged pages of 16 and
    of 5 positions (a page boundary is no tile boundary)."""
    s = 1024
    q, k, v, kv = _inputs(len(SPLIT_EDGES), s, 2, 4, 128, SPLIT_EDGES,
                          dtype, cuda_device)
    torch.testing.assert_close(decode_attention(q, k, v, kv).float(),
                               decode_attention_ref(q, k, v, kv).float(),
                               **TOL[dtype])
    nb = -(-s // bs)
    args = _paged_inputs(SPLIT_EDGES, nb, bs, 2, 4, 128, dtype, cuda_device)
    torch.testing.assert_close(paged_decode_attention(*args).float(),
                               paged_decode_attention_ref(*args).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernels_with_idle_clusters(cuda_device, dtype):
    """A batch of 16 rows, most at kv_len 1 (seven of each cluster's eight
    blocks have no positions) and two at kv_len 0 (their whole clusters
    idle: the kernel writes zeros there); every other row matches its
    plain version, and the empty rows change nothing around them."""
    lens = [1, 1, 0, 1, 700, 1, 1, 1, 1, 0, 1, 33, 1, 1, 1, 1]
    live = [i for i, n in enumerate(lens) if n]
    q, k, v, kv = _inputs(len(lens), 1024, 8, 4, 128, lens, dtype,
                          cuda_device)
    tables = _identity_paged(k, v, 16)
    for got in (decode_attention(q, k, v, kv),
                paged_decode_attention(q, *tables, kv)):
        assert not got[[2, 9]].any()
        torch.testing.assert_close(
            got[live].float(),
            decode_attention_ref(q, k, v, kv)[live].float(), **TOL[dtype])
        one = decode_attention(q[4:5].contiguous(), k[4:5].contiguous(),
                               v[4:5].contiguous(), kv[4:5])
        assert torch.equal(one[0], got[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [112, 128])
@pytest.mark.parametrize("rep", [1, 4, 6, 12, 48])
def test_decode_kernels_at_every_gqa_ratio(cuda_device, rep, hd, dtype):
    """GQA ratios 1 (zamba2-7b's MHA), 4 (qwen3-4b), 6, 12
    (mistral-large-123b) and 48 (granite-34b) at hd 112 and 128: the dense
    kernel, and the paged one over pages of 16 and of 5 positions, against
    their plain versions; on identity tables paged equals dense bit for
    bit."""
    lens = [1, 1024, 37, 400, 257, 1000]
    kvh = 2 if rep < 48 else 1
    q, k, v, kv = _inputs(len(lens), 1024, kvh, rep, hd, lens, dtype,
                          cuda_device)
    dense = decode_attention(q, k, v, kv)
    torch.testing.assert_close(dense.float(),
                               decode_attention_ref(q, k, v, kv).float(),
                               **TOL[dtype])
    assert torch.equal(paged_decode_attention(q, *_identity_paged(k, v, 16),
                                              kv), dense)
    for bs in (16, 5):
        args = _paged_inputs(lens, -(-1024 // bs), bs, kvh, rep, hd, dtype,
                             cuda_device)
        torch.testing.assert_close(
            paged_decode_attention(*args).float(),
            paged_decode_attention_ref(*args).float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_kernel_replays_in_a_cuda_graph(cuda_device, paged):
    """One capture of the entry point; the replay on new inputs copied into
    the captured buffers equals an eager call on them bit for bit, and
    the capture counts one launch (the wrapper's counter runs at capture,
    not at replay)."""
    lens = [300, 5, 1024, 77]
    fn = paged_decode_attention if paged else decode_attention

    def args(seed):
        q, k, v, kv = _inputs(4, 1024, 8, 4, 128, lens, torch.bfloat16,
                              cuda_device, seed=seed)
        return (q, *_identity_paged(k, v, 16), kv) if paged else (q, k, v, kv)

    static = args(0)
    fn(*static)                          # load the library outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = fn.launches
    with torch.cuda.graph(graph):
        out = fn(*static)
    assert fn.launches == before + 1
    fresh = args(1)
    for dst, src in zip(static, fresh):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn(*fresh))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("records,l_out,k,stride", [
    (2, -1, 7, 1), (2, 0, 7, 1), (2, 1, 5, 2), (3, 1, 3, 4),
    ("sms+1", 4 * 128 + 1, 7, 1), ("sms+1", 1, 5, 2)],
    ids=["tile-1", "tile", "tile+1", "tile+1-s4", "grid-tail",
         "grid-tail-s2"])
def test_conv_kernel_at_tile_and_grid_tails(cuda_device, records, l_out, k,
                                            stride, dtype):
    """L_out = kTile - 1, kTile, kTile + 1 (ops.TILE: the last tile of a
    record ragged or whole), and B = SMs + 1 records, enough tiles that
    the persistent grid's blocks walk several each and the last wave is
    ragged."""
    from repro_torch.kernels.conv1d.ops import TILE
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    b = sms + 1 if records == "sms+1" else records
    if l_out <= 1:
        l_out = TILE + l_out
    length = (l_out - 1) * stride + k
    args = _conv_inputs(b, length, 32, k, 32, dtype, cuda_device)
    got = dwsep_conv1d(*args, stride=stride)
    torch.cuda.synchronize()
    assert got.shape == (b, l_out, 32)
    torch.testing.assert_close(
        got.float(), dwsep_conv1d_ref(*args, stride=stride).float(),
        **CONV_TOL[dtype])


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


def _ssd_checked(args, path, dtype, chunk=256):
    """One scan through the wrapper: on ``path`` (launches_by_path), and
    equal to the plain version at SSD_TOL (y in x's dtype, the f32 state
    at 1e-4)."""
    before = dict(ssd_scan.launches_by_path)
    y, state = ssd_scan(*args, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches_by_path[path] == before[path] + 1
    want_y, want_state = ssd_chunked(*args, chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(state, want_state, **SSD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("q", [-1, 0, 1, 65], ids=["Q-1", "Q", "Q+1", "2Q+1"])
def test_ssd_kernel_at_its_chunk_edges(cuda_device, q, n):
    """L = Q - 1, Q, Q + 1 and 2Q + 1 of the chunked path's own chunk
    (ssd ops.CHUNK): the rows past L of the last chunk load as zeros and
    add nothing, to y or to the state."""
    from repro_torch.kernels.ssd.ops import CHUNK
    length = CHUNK + q
    args = _ssd_inputs(2, length, 8, 64, 1, n, torch.bfloat16, cuda_device)
    _ssd_checked(args, "chunked", torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_kernel_bf16_takes_large_steps(cuda_device, n):
    """The chunked path at steps of dt up to 5 (A up to 16): decays over a
    chunk reach exp(-5000), and cum[t] - cum[s] would lose 1e-4 of the
    decay's accuracy in plain f32; the f32 state still agrees at 1e-4."""
    args = _ssd_inputs(2, 200, 8, 64, 2, n, torch.bfloat16, cuda_device,
                       dt_hi=5.0)
    _ssd_checked(args, "chunked", torch.bfloat16, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,h,g,n", [(1, 300, 12, 3, 64),
                                            (2, 130, 8, 2, 128),
                                            (1, 129, 16, 8, 64)])
def test_ssd_kernel_with_groups(cuda_device, b, length, h, g, n):
    """G > 1 on the chunked path: a block serves one head, so the blocks
    of neighbouring heads read B and C of different groups (h / (H / G));
    at H 16 over G 8 every other head crosses a group boundary."""
    args = _ssd_inputs(b, length, h, 64, g, n, torch.bfloat16, cuda_device)
    _ssd_checked(args, "chunked", torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,p,length,path", [
    (torch.bfloat16, 64, 64, 150, "chunked"),
    (torch.bfloat16, 128, 128, 9, "chunked"),
    (torch.bfloat16, 64, 64, 8, "step"),
    (torch.bfloat16, 128, 64, 1, "step"),
    (torch.float32, 64, 64, 150, "step"),
    (torch.float32, 128, 64, 150, "step"),
    (torch.bfloat16, 32, 64, 150, "step"),
    (torch.bfloat16, 64, 32, 150, "step"),
    (torch.bfloat16, 16, 16, 150, "step"),
], ids=["bf16-64-64", "bf16-128-128-L9", "bf16-64-64-L8", "bf16-128-64-L1",
        "f32-64-64", "f32-128-64", "bf16-32-64", "bf16-64-32", "bf16-16-16"])
def test_ssd_entry_point_picks_the_path_from_the_shape(cuda_device, dtype, n,
                                                       p, length, path):
    """Each path of the entry point's rule, held against the plain
    version: bf16 at N 64/128, P a multiple of 64 and more than 8 steps
    on the tensor cores, everything else step by step."""
    args = _ssd_inputs(2, length, 4, p, 2, n, dtype, cuda_device)
    _ssd_checked(args, path, dtype)


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


# (H, KVH, hd) of every model whose prefill runs the flash kernel:
# qwen3-4b, qwen2-0.5b, zamba2-7b's shared block (chip_smoke.ATTN_SHAPES)
# and dbrx-132b; prompt lengths around the 64-row tiles, and long ones
FLASH_WGMMA_SHAPES = [(32, 8, 128), (14, 2, 64), (32, 32, 112),
                      (48, 8, 128)]
FLASH_WGMMA_LENGTHS = [1, 13, 63, 64, 65, 127, 700, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("s", FLASH_WGMMA_LENGTHS)
@pytest.mark.parametrize("h,kvh,hd", FLASH_WGMMA_SHAPES,
                         ids=["qwen3", "qwen2", "zamba2", "dbrx"])
def test_flash_tensor_core_path_matches_plain_version(cuda_device, h, kvh,
                                                      hd, s):
    """bf16 prefill through the wgmma kernel (the path the entry point
    reports), against the plain version at the bf16 tolerance."""
    gen = torch.Generator(device="cpu").manual_seed(s)
    q, k, v = (torch.randn(1, s, n, hd, generator=gen).to(cuda_device,
                                                           torch.bfloat16)
               for n in (h, kvh, kvh))
    before = flash_attention.launches_by_path["wgmma"]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["wgmma"] == before + 1
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v).float(),
                               **TOL[torch.bfloat16])


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
@pytest.mark.parametrize("c", [17, 40, 64, 65, 223, 224, 225])
@pytest.mark.parametrize("e,d,f", [(16, 6144, 10752), (16, 10752, 6144),
                                   (4, 6144, 1000)],
                         ids=["gate_up", "down", "ragged_f"])
def test_gmm_wgmma_path_at_dbrx_prefill_shapes(cuda_device, e, c, d, f):
    """Capacities around the m64 blocks and the 256-row tile at
    dbrx-132b's widths, and an F no 128-column tile divides: the wgmma
    path (launches_by_path says so), elementwise and normwise."""
    x, w = _gmm_inputs(e, c, d, f, torch.bfloat16, cuda_device, seed=c)
    before = dict(gmm.launches_by_path)
    got = gmm(x, w)
    torch.cuda.synchronize()
    assert gmm.launches_by_path["wgmma"] == before["wgmma"] + 1
    want = gmm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **GMM_TOL[torch.bfloat16])
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,d,f,path", [
    (torch.bfloat16, 8, 6144, 10752, "decode"),
    (torch.bfloat16, 16, 256, 136, "decode"),
    (torch.bfloat16, 17, 100, 72, "wmma"),
    (torch.bfloat16, 40, 96, 130, "wmma"),
    (torch.bfloat16, 17, 96, 256, "wgmma"),
    (torch.float32, 224, 128, 64, "f32"),
], ids=["decode", "decode_edge", "wmma_d100", "wmma_f130", "wgmma", "f32"])
def test_gmm_entry_point_picks_the_path_from_the_shape(cuda_device, dtype, c,
                                                       d, f, path):
    x, w = _gmm_inputs(2, c, d, f, dtype, cuda_device)
    before = dict(gmm.launches_by_path)
    got = gmm(x, w)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in gmm.launches_by_path.items()} == {
        k: int(k == path) for k in before}
    torch.testing.assert_close(got.float(), gmm_ref(x, w).float(),
                               **GMM_TOL[dtype])


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


@pytest.mark.cuda
def test_search_and_serve_winner_on_the_card(cuda_device, monkeypatch):
    """HALF's loop with the default device (the card), at toy size: the
    search's two scheduler threads train and evaluate every candidate
    through the conv kernel, serve_winner answers from two replicas, and a
    narrow bucket of four quant settings trains batched as it does scalar
    (five steps: rounding has no room to grow)."""
    import dataclasses

    from repro_torch.core import EvolutionarySearch, NASConfig
    from repro_torch.core.genome import Genome
    from repro_torch.core.objectives import expensive_objectives
    from repro_torch.core.trainer import train_candidate
    from repro_torch.core.trainer_batch import train_candidates_batched
    from repro_torch.data.ecg import make_ecg_dataset, train_val_split
    from repro_torch.serve import serve_winner

    tr, va = train_val_split(*make_ecg_dataset(0, n_samples=48,
                                               decimation=16))
    monkeypatch.setattr(dwsep_conv1d, "launches", 0)
    cfg = NASConfig(generations=2, children_per_gen=4, n_accept=2,
                    init_population=3, train_steps=5, train_batch=8,
                    n_workers=2, pipeline="host_overlap", det_min=0.0,
                    fa_max=1.0)
    search = EvolutionarySearch(cfg, tr, va, log=lambda *_: None)
    assert search.device.type == "cuda"
    state = search.run()
    assert state.pop.trained_mask.all() and dwsep_conv1d.launches > 0
    winner = serve_winner(search, state, data_train=tr, data_val=va,
                          train_steps=5, train_batch=8, replicas=2,
                          log=lambda *_: None)
    assert winner.classify(va[0]).shape == (len(va[0]),)
    narrow = Genome(op_genes=(31, 61, 39, 23) + (0,) * 11,
                    conn_genes=tuple(range(15)), out_gene=4, w_bits_gene=0,
                    a_bits_gene=0, i_bits_gene=1, dec_gene=1)
    bucket = [dataclasses.replace(narrow, w_bits_gene=w, a_bits_gene=a,
                                  i_bits_gene=i)
              for w, a, i in ((1, 1, 1), (0, 1, 1), (1, 0, 1), (1, 1, 0))]
    kw = dict(steps=5, batch_size=8, seed=0)
    batched = train_candidates_batched(bucket, tr, va, **kw)
    for g, b in zip(bucket, batched):
        s = train_candidate(g, tr, va, **kw)
        assert (expensive_objectives(b) == expensive_objectives(s)).all()
        assert abs(b.val_loss - s.val_loss) < 5e-3
