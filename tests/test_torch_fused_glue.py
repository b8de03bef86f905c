"""A decoder layer's glue, fused (``models/glue.py``, ``kernels/glue``,
``csrc/glue.cu``).

On the CPU: where each glue site picks the fused op (CUDA bf16 tensors of
an RMSNorm model with plain RoPE, no mesh, DTensor or fake tensor, no
gradient through the site) and where it keeps PyTorch's ops; the layer
loops of the fused path, run with the kernels' plain versions (the
device the path is chosen on pointed at the CPU), against PyTorch's path
bit for bit through the paged engine; and the ``model.glue`` span of each
paged call.

On the card (marked ``cuda``): each kernel against the PyTorch glue it
replaces at the served models' widths (mistral-large-123b, dbrx-132b,
zamba2-7b's head dim 112, granite-34b's 48/1), at the decode step's 64
rows with positions up to 2047 and masked rows writing their spare
positions, and at prefill buckets B 1-8, L 8-1024: RoPE, SwiGLU, the add
and the pool write bit for bit, the RMSNorm within one bf16 ulp, and pool
positions no row writes untouched.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import trace as T
from repro_torch.configs import reduced_config
from repro_torch.distributed.sharding import axis_rules, default_rules
from repro_torch.kernels import _launches as K
from repro_torch.kernels import glue as ops
from repro_torch.models import attention as A
from repro_torch.models import decode_graph as DG
from repro_torch.models import glue
from repro_torch.models.hybrid import _layout
from repro_torch.models.common import apply_rope, rmsnorm
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, ServeEngine, ServeRequest

# (prompt length, max_new) over 3 slots with blocks of 8: buckets of
# several rows with pad tails, rows crossing block boundaries, churn
BURST = [(5, 7), (13, 4), (8, 9), (3, 5), (17, 4), (9, 6)]
ENGINE = dict(slots=3, cache_len=48, pad_to=4, max_prefill_batch=2,
              paged=True, block_size=8)


@pytest.fixture
def on_cpu(monkeypatch):
    """The fused path chosen for CPU tensors (where the ops run their
    plain versions)."""
    monkeypatch.setattr(glue, "DEVICE", "cpu")


def _sites(fn, *args, **kwargs):
    """(fn's result, the (fused, torch) glue sites it ran)."""
    f0, t0 = glue.site_counts()
    out = fn(*args, **kwargs)
    f1, t1 = glue.site_counts()
    return out, (f1 - f0, t1 - t0)


# ---------------------------------------------------------------------------
# The choice
# ---------------------------------------------------------------------------

CHOICE = {
    # case: (device the path is chosen on, dtype, config changes, grad,
    #        rules, fused)
    "card": ("cpu", torch.bfloat16, {}, None, False, True),
    "cpu": ("cuda", torch.bfloat16, {}, None, False, False),
    "float32": ("cpu", torch.float32, {}, None, False, False),
    "layernorm": ("cpu", torch.bfloat16, {"norm": "layernorm"}, None, False,
                  False),
    "mrope": ("cpu", torch.bfloat16, {"mrope": True}, None, False, False),
    "autograd": ("cpu", torch.bfloat16, {}, "x", False, False),
    "autograd on a weight": ("cpu", torch.bfloat16, {}, "scale", False,
                             False),
    "requires grad under no_grad": ("cpu", torch.bfloat16, {}, "no_grad",
                                    False, True),
    "mesh": ("cpu", torch.bfloat16, {}, None, True, False),
}


@pytest.mark.parametrize("case", list(CHOICE))
def test_each_site_picks_its_path_from_what_it_sees(case, monkeypatch):
    device, dtype, changes, grad, rules, want = CHOICE[case]
    monkeypatch.setattr(glue, "DEVICE", device)
    cfg = dataclasses.replace(reduced_config("mistral-large-123b"),
                              **changes)
    x = torch.randn(2, 3, cfg.d_model).to(dtype)
    scale = torch.ones(cfg.d_model, dtype=dtype)
    if grad in ("x", "no_grad"):
        x.requires_grad_(True)
    elif grad == "scale":
        scale.requires_grad_(True)
    ctx = contextlib.ExitStack()
    if grad == "no_grad":
        ctx.enter_context(torch.no_grad())
    if rules:
        ctx.enter_context(axis_rules(default_rules(), {"data": 1,
                                                       "model": 1}))
    with ctx:
        assert glue.fused(cfg, x, None, scale) is want
        norm = {"scale": scale, "bias": torch.zeros_like(scale)}
        _, sites = _sites(glue.add_norm, x, x, norm, cfg)
    assert sites == ((1, 0) if want else (0, 1))


def test_fake_tensors_keep_the_torch_ops(on_cpu):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = reduced_config("mistral-large-123b", dtype="bfloat16")
    with FakeTensorMode():
        x = torch.empty(2, 3, cfg.d_model, dtype=torch.bfloat16)
        assert not glue.fused(cfg, x)


def _model(arch, dtype="bfloat16"):
    cfg = reduced_config(arch, dtype=dtype)
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(0, device="cpu")


def _sites_a_forward(cfg):
    """Glue sites of one LM forward: a norm, RoPE, a norm and SwiGLU a
    layer (a shared expert's SwiGLU too), and the final norm; four a
    hybrid's shared-block application."""
    if cfg.family == "hybrid":
        return 4 * _layout(cfg)[0]
    return (4 + bool(cfg.n_shared_experts)) * cfg.n_layers + 1


@pytest.mark.parametrize("arch, fused", [
    ("whisper-tiny", False), ("qwen2-vl-2b", False),
    ("mistral-large-123b", True)])
def test_layernorm_and_mrope_families_keep_the_torch_ops(arch, fused,
                                                         on_cpu):
    """With the path chosen on the CPU, a whisper-tiny (LayerNorm, GELU)
    and a qwen2-vl-2b (M-RoPE) prefill run no fused site; a plain LM runs
    every site fused."""
    cfg, bundle, params = _model(arch)
    if cfg.family == "encdec":
        batch = {"frames": torch.randn(1, 16, cfg.d_model).to(torch.bfloat16),
                 "dec_tokens": torch.zeros((1, 4), dtype=torch.int64)}
    elif cfg.family == "vlm":
        batch = {"embeds": torch.randn(1, 4, cfg.d_model).to(torch.bfloat16),
                 "positions": torch.arange(4)[None, None].expand(3, 1, 4)}
    else:
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    with torch.no_grad():
        _, (f, t) = _sites(bundle.prefill, params, dict(batch, cache_len=8))
    assert f == (_sites_a_forward(cfg) if fused else 0)
    assert fused or t > 0 or cfg.family == "encdec"


def test_training_keeps_the_torch_ops(on_cpu):
    """A train step's forward under autograd: every site on PyTorch's
    ops, and the same loss as with the path chosen on the card alone."""
    cfg, bundle, params = _model("dbrx-132b")
    for leaf in params["layers"][0]["attn"].values():
        leaf.requires_grad_(True)
    params["embed"].requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    (logits, _), sites = _sites(bundle.apply_train, params,
                                {"tokens": tokens})
    assert sites == (0, _sites_a_forward(cfg))
    logits.float().sum().backward()
    assert params["embed"].grad is not None


# ---------------------------------------------------------------------------
# The fused path's layer loops, on the plain versions, against PyTorch's
# ---------------------------------------------------------------------------


def _requests(cfg):
    rng = np.random.default_rng(3)
    return [ServeRequest(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new=m)
            for i, (n, m) in enumerate(BURST)]


def _serve(cfg, bundle, params):
    """(tokens, every step's logits and pools, the engine's glue spans)."""
    steps = []
    decode = bundle.decode_paged

    def recording(p, cache, batch):
        logits, out = decode(p, cache, batch)
        steps.append((logits.clone(), out["k"].clone(), out["v"].clone()))
        return logits, out
    engine = ServeEngine(dataclasses.replace(bundle, decode_paged=recording),
                         params, EngineConfig(**ENGINE), device="cpu")
    with torch.no_grad():
        tokens = [r.out for r in engine.run(_requests(cfg))]
    spans = [s for s in T.TRACER.snapshot().named("model.glue")
             if s.engine == engine.trace_tag]
    return tokens, steps, spans, engine


@pytest.mark.parametrize("arch", ["mistral-large-123b", "dbrx-132b",
                                  "granite-34b", "qwen3-4b", "qwen2-0.5b",
                                  "zamba2-7b"])
def test_fused_path_equals_the_torch_path(arch, monkeypatch):
    """Served tokens, every decode step's logits and K/V pools: the fused
    path's loops (each residual add made at the norm after it, the final
    norm of the last rows only, the pool write by RoPE) on the kernels'
    plain versions equal PyTorch's path bit for bit.  Each paged call
    records one ``model.glue`` span, all its sites on the path taken."""
    cfg, bundle, params = _model(arch)
    if cfg.family == "hybrid":     # exact-length prefills
        monkeypatch.setitem(ENGINE, "pad_to", 1)
    tok_t, steps_t, spans_t, eng_t = _serve(cfg, bundle, params)
    monkeypatch.setattr(glue, "DEVICE", "cpu")
    tok_f, steps_f, spans_f, eng_f = _serve(cfg, bundle, params)
    assert tok_f == tok_t and len(steps_f) == len(steps_t) > 0
    for a, b in zip(steps_f, steps_t):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    n = _sites_a_forward(cfg)
    calls = eng_t.decode_steps + len(
        [s for s in T.TRACER.snapshot().named("serve.prefill")
         if s.engine == eng_t.trace_tag])
    assert len(spans_t) == len(spans_f) == calls
    assert {s.attrs for s in spans_t} == {(0, n)}
    assert {s.attrs for s in spans_f} == {(n, 0)}


class _Rerun:
    """A stand-in for a CUDA graph on the CPU: ``replay`` reruns the
    captured function into the first run's outputs and, as a graph's
    replay calls no wrapper, takes back what the rerun counted."""

    def __init__(self, run):
        self.run = run
        self.outs = run()

    def replay(self):
        before = K.launch_counts()
        for have, new in zip(self.outs, self.run()):
            if have is not None:
                have.copy_(new)
        K.add_launches(K.launches_since(before), -1)


class _CpuGraph(DG._Graph):
    def _capture(self, run):
        self.graph = _Rerun(run)
        return self.graph.outs


class CpuGraphs(DG.DecodeGraphs):
    DEVICE = "cpu"
    Graph = _CpuGraph


def test_replayed_steps_record_their_captures_sites(on_cpu):
    """The decode graph's runner (a stand-in graph on the CPU): a replay
    records the glue sites its capture ran, and the capture's own count
    is taken back."""
    cfg, bundle, params = _model("qwen3-4b")
    graphs = CpuGraphs(bundle.decode_paged.eager)
    cache = bundle.make_paged_cache(3, 48, 18, 8, device="cpu")
    batch = {"tokens": torch.zeros((3, 1), dtype=torch.int32),
             "active": torch.tensor([True, False, True])}
    n = _sites_a_forward(cfg)
    with torch.no_grad():
        for mode in ("capture", "replay", "replay"):
            _, sites = _sites(graphs, params, cache, batch)
            span = T.TRACER.snapshot().named("model.glue")[-1]
            assert span.attrs == sites == (n, 0), mode


@pytest.mark.parametrize("spare", [True, False])
def test_pool_write_by_rope_writes_only_the_rows_kept(spare, monkeypatch):
    """The paged step's write: with spare blocks every row writes (a
    masked one its spare position); without, rows not kept write
    nothing.  Fused (plain versions) and PyTorch's path alike."""
    cfg = reduced_config("mistral-large-123b", dtype="bfloat16")
    p = A.init_attention(torch.Generator().manual_seed(0), cfg)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    b, bs, n_blocks, hd = 4, 8, 6, cfg.resolved_head_dim
    shape = (1, n_blocks, bs, cfg.n_kv_heads, hd, b, torch.bfloat16,
             "cpu")
    lens = torch.tensor([3, 9, 0, 15], dtype=torch.int32)
    tables = torch.tensor([[0, 1], [2, 3], [6, 6], [4, 5]],
                          dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    x = torch.randn(b, 1, cfg.d_model).to(torch.bfloat16)
    spare_blocks = A.pool_with_spare(A.paged_pool(*shape)).shape[1]
    start = [torch.randn(1, spare_blocks, bs, cfg.n_kv_heads, hd).to(
        torch.bfloat16) for _ in range(2)]
    out = {}
    for path in ("cpu", "none"):
        monkeypatch.setattr(glue, "DEVICE", path)
        pools = [t.clone()[:, :n_blocks] for t in start]
        cache = {"k": pools[0], "v": pools[1], "lens": lens,
                 "tables": tables}
        if not spare:
            cache = {k: v.clone() for k, v in cache.items()}
        write, kd, vd = A.paged_write(cache, active)
        assert isinstance(write[0], slice) is spare
        with torch.no_grad():
            (y, _, _), sites = _sites(
                A.attention_decode_paged, p, x, cache["k"][0],
                cache["v"][0], lens + 1, tables, write,
                (kd[0], vd[0]), cfg)
        assert sites == ((1, 0) if path == "cpu" else (0, 1))
        out[path] = (y, kd.clone(), vd.clone())
    for a, c in zip(out["cpu"], out["none"]):
        assert torch.equal(a, c)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.add_rmsnorm(x.float(), None, torch.ones(8), 1e-5)
    with pytest.raises(ValueError, match="scale"):
        ops.add_rmsnorm(x, x, torch.ones(4), 1e-5)
    q = torch.zeros(1, 2, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="frequencies"):
        ops.rope(q, q[:, :, :1].contiguous(), None, torch.ones(3))
    with pytest.raises(ValueError, match="positions"):
        ops.rope(q, q, torch.zeros(1, 3, dtype=torch.int32),
                 torch.ones(4))
    with pytest.raises(ValueError, match="differ"):
        ops.swiglu(x, x[:1].contiguous())


# ---------------------------------------------------------------------------
# On the card: each kernel against the PyTorch glue it replaces
# ---------------------------------------------------------------------------

# (name, d_model, H, KVH, hd, d_ff)
WIDTHS = [("mistral-large-123b", 12288, 96, 8, 128, 28672),
          ("dbrx-132b", 6144, 48, 8, 128, 10752),
          ("zamba2-7b", 3584, 32, 32, 112, 14336),
          ("granite-34b", 6144, 48, 1, 128, 24576)]
BUCKETS = [(1, 8), (3, 136), (8, 1024)]     # prefill (B, L)
DECODE_ROWS = 64
THETA = 1e4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bf16(shape, device, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(torch.bfloat16)


def _within_one_ulp(y: torch.Tensor, ref: torch.Tensor) -> bool:
    """Every element of bf16 ``y`` at most one bf16 ulp from ``ref``."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return bool(((y.float() - r).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
@pytest.mark.parametrize("rows", [(DECODE_ROWS, 1)] + BUCKETS,
                         ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
def test_add_rmsnorm_kernel(width, rows, scale_dtype, cuda_device):
    d = width[1]
    gen = torch.Generator(device=cuda_device).manual_seed(d + rows[1])
    x = _bf16((*rows, d), cuda_device, gen)
    a = _bf16((*rows, d), cuda_device, gen, 0.5)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device=cuda_device)
             ).to(scale_dtype)
    before = ops.add_rmsnorm.launches_by_path.copy()
    h, y = ops.add_rmsnorm(x, a, scale, 1e-5)
    _, y0 = ops.add_rmsnorm(x, None, scale, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(h, x + a)
    assert _within_one_ulp(y, rmsnorm(x + a, scale, 1e-5))
    assert _within_one_ulp(y0, rmsnorm(x, scale, 1e-5))
    assert ops.add_rmsnorm.launches_by_path["add"] == before["add"] + 1
    assert ops.add_rmsnorm.launches_by_path["norm"] == before["norm"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
@pytest.mark.parametrize("rows", BUCKETS, ids=lambda r: f"{r[0]}x{r[1]}")
def test_rope_kernel_at_prefill_buckets(width, rows, cuda_device):
    """Positions 0..L-1 (no tensor), and each row from its own start as
    int64 (B, L) and int32 (B, 1) broadcast."""
    _, _, h, kvh, hd, _ = width
    b, s = rows
    gen = torch.Generator(device=cuda_device).manual_seed(hd * s + b)
    q = _bf16((b, s, h, hd), cuda_device, gen, 4.0)
    k = _bf16((b, s, kvh, hd), cuda_device, gen, 4.0)
    freqs = glue._freqs(hd, THETA, q.device)
    start = torch.randint(0, 2048 - s, (b, 1), generator=gen,
                          device=cuda_device)
    for pos in (None, start + torch.arange(s, device=cuda_device),
                start.to(torch.int32).expand(b, s)):
        qr, kr = ops.rope(q, k, pos, freqs)
        want = pos if pos is not None else torch.arange(
            s, device=cuda_device)[None].expand(b, s)
        assert torch.equal(qr, apply_rope(q, want, THETA))
        assert torch.equal(kr, apply_rope(k, want, THETA))


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_rope_write_kernel_at_the_decode_step(width, cuda_device):
    """64 rows at positions up to 2047, ~60% active, the others writing
    their spare positions (``paged_write_index``); also rows writing
    nothing (block -1).  The rotated q, and the pools against PyTorch's
    index_put_ of the rotated k and the v: every position no row writes
    untouched."""
    _, _, h, kvh, hd, _ = width
    b, bs, nb = DECODE_ROWS, 16, 128
    n_blocks = b * nb + 4
    gen = torch.Generator(device=cuda_device).manual_seed(hd + kvh)
    q = _bf16((b, 1, h, hd), cuda_device, gen, 4.0)
    k = _bf16((b, 1, kvh, hd), cuda_device, gen, 4.0)
    v = _bf16((b, 1, kvh, hd), cuda_device, gen)
    lens = torch.randint(0, 2048, (b,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    lens[:4] = torch.tensor([0, 15, 16, 2047])
    tables = torch.randperm(n_blocks, generator=gen, device=cuda_device)[
        :b * nb].view(b, nb).to(torch.int32)
    active = torch.rand(b, generator=gen, device=cuda_device) < 0.6
    spare = -(-b // bs)
    rows, blk, off = A.paged_write_index(lens, tables, active, bs,
                                         n_blocks, spare)
    freqs = glue._freqs(hd, THETA, q.device)
    for drop in (False, True):
        blk_w = torch.where(torch.arange(b, device=cuda_device) % 5 == 0,
                            -1, blk) if drop else blk
        pools = [_bf16((n_blocks + spare, bs, kvh, hd), cuda_device, gen)
                 for _ in range(2)]
        want = [t.clone() for t in pools]
        qr = ops.rope_write(q, k, v, lens + 1, freqs, *pools, blk_w, off)
        pos = lens[:, None]
        keep = blk_w >= 0
        want[0][blk_w[keep], off[keep]] = apply_rope(k, pos, THETA)[keep, 0]
        want[1][blk_w[keep], off[keep]] = v[keep, 0]
        assert torch.equal(qr, apply_rope(q, pos, THETA))
        assert torch.equal(pools[0], want[0])
        assert torch.equal(pools[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (DECODE_ROWS, 1, 28672), (1, 1024, 28672), (8, 136, 14336),
    (16, 24, 10752), (16, 224, 10752), (3, 5, 7)],
    ids=lambda s: "x".join(map(str, s)))
def test_swiglu_kernel(shape, cuda_device):
    """Dense rows (mistral-large-123b, zamba2-7b) and dbrx-132b's expert
    buffers (E, C, d_ff) at decode and prefill, and a ragged size."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[-1])
    g = _bf16(shape, cuda_device, gen, 4.0)
    u = _bf16(shape, cuda_device, gen)
    assert torch.equal(ops.swiglu(g, u), F.silu(g) * u)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mistral-large-123b", "dbrx-132b",
                                  "zamba2-7b"])
def test_paged_prefill_fused_against_torch_glue(arch, cuda_device,
                                                monkeypatch):
    """A reduced model's paged prefill on the card with the glue fused and
    with PyTorch's glue: every site fused in the first and none in the
    second, logits and K/V rows normwise within 1e-2."""
    cfg = reduced_config(arch, dtype="bfloat16")
    bundle = build_model(cfg)
    params = bundle.init(0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    lens = [24, 24, 24] if cfg.family == "hybrid" else [24, 17, 9]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 24),
                                     generator=gen, device=cuda_device),
             "lens": torch.tensor(lens, dtype=torch.int32,
                                  device=cuda_device)}
    out = {}
    for path in ("cuda", "none"):
        monkeypatch.setattr(glue, "DEVICE", path)
        with torch.no_grad():
            (logits, cache), sites = _sites(bundle.prefill_paged, params,
                                            batch)
        n = _sites_a_forward(cfg)
        assert sites == ((n, 0) if path == "cuda" else (0, n))
        out[path] = (logits, cache["k"], cache["v"])
    for a, b in zip(out["cuda"], out["none"]):
        a, b = a.float(), b.float()
        assert float((a - b).norm() / b.norm()) <= 1e-2


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 3f, rehearsed on the CPU at toy widths
# ---------------------------------------------------------------------------

TOY_GLUE = dict(widths=[("toy", 64, 4, 2, 16, 96, 1e4)],
                buckets=[(1, 8), (2, 24)], rows=8,
                experts=[(4, 3, 96)])


def _rehearse_glue_phase(monkeypatch, **wrong):
    """phase_glue_kernels on the CPU (where the ops run their plain
    versions), timings stubbed; ``wrong`` names ops made to differ."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, sets: 1.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in wrong:
        op = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _op=op: _op(*a) + 1)
    return chip_smoke.phase_glue_kernels(torch, device="cpu",
                                         **TOY_GLUE), lines


def test_chip_smoke_glue_phase_runs_on_cpu(monkeypatch):
    cases, lines = _rehearse_glue_phase(monkeypatch)
    kinds = [c["case"].split()[2] for c in cases]
    assert kinds.count("add_rmsnorm") == kinds.count("rmsnorm") == 3
    assert kinds.count("rope") == 2 and kinds.count("rope_write") == 1
    assert kinds.count("swiglu") == 3
    assert all(c["bound_ms"] > 0 for c in cases)
    assert any("rope_write 8 rows" in line and "both pools" in line
               for line in lines)


@pytest.mark.parametrize("op", ["swiglu", "rope_write"])
def test_chip_smoke_glue_phase_gates_on_the_kernels(op, monkeypatch):
    with pytest.raises(RuntimeError, match="differ"):
        _rehearse_glue_phase(monkeypatch, **{op: True})
