"""The dense cell, ``mistral-large-123b.chat``: the formula of its matrix
products' roofline, the readers ``dense_gemm_decode_roofline`` and
``mfu.prefill`` on made-up spans and a made-up device trace, what the
cell reports, and a whole run at a reduced size on the CPU judged by the
cell's own limits."""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import bench
from portbench.harness import loop as L
from portbench.harness import spec as S
from portbench.harness.trace import DeviceTrace, Span, Spans
from portbench.roofline import dense_gemm, peaks, step
from repro_torch import trace as T

CELL = "mistral-large-123b.chat"
MS = 10 ** 6
S_NS = 10 ** 9
EPOCH = 1_700_000_000 * S_NS
MISTRAL = S.load_json(S.BENCH_DIR / "configs" / "mistral-large-123b.json")
# 2 layers, GQA 4/2 at head size 16, d_ff 128, vocabulary 100
SMALL = {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 100}


def read(name, ctx):
    return S.metric_reader(name).read(ctx)


# ---- the roofline of the dense products ----------------------------------

def test_a_product_reads_its_weight_and_rows_once():
    assert dense_gemm.flops_bytes(64, 12288, 1024) == (
        2 * 64 * 12288 * 1024, (12288 * 1024 + 64 * 12288 + 64 * 1024) * 2)


def test_mistral_decode_products_at_64_rows():
    # weights: 21 layers of q, o (12288 x 12288), k, v (12288 x 1024),
    # gate, up, down (12288 x 28672) = 1,384,120,320 each, and the
    # unembedding 12288 x 32768 = 402,653,184
    weights = 21 * 1_384_120_320 + 402_653_184
    # rows in: 6 products from 12288, down from 28672; rows out: q, o,
    # down 12288, k, v 1024, gate, up 28672; the unembedding's 12288 in
    # and 32768 out
    rows = 21 * 64 * (6 * 12288 + 28672 + 3 * 12288 + 2 * 1024
                      + 2 * 28672) + 64 * (12288 + 32768)
    assert weights + rows == 29_739_057_152
    least = dense_gemm.step_least_s(MISTRAL, 64, peaks.least_s)
    # every product is bound by its bytes at 64 rows: 17.75 ms
    assert least == pytest.approx(2 * 29_739_057_152 / 3.35e12, rel=1e-12)
    assert 17.7e-3 < least < 17.8e-3


def test_kernel_names():
    assert dense_gemm.is_gemm("nvjet_tst_64x64_64x13_4x1_v_bz_NNT")
    assert dense_gemm.is_gemm("void cublasLt::splitKreduce_kernel<32, 16, "
                              "int, float, __nv_bfloat16>")
    assert not dense_gemm.is_gemm("void decode_attention_kernel<bf16>")
    assert not dense_gemm.is_gemm("gmm_decode_kernel")


# ---- dense_gemm_decode_roofline on a made-up trace ----------------------

def traced_steps(cfg, ops_by_step, rows=4):
    """A Context whose traced part (perf 10-20 s) holds one ``engine.step``
    span a list of ``ops_by_step`` ((name, start, end) in ms from the
    span's start), 20 ms apart, each over ``rows`` rows."""
    spans = Spans()
    spans.to_epoch = EPOCH
    lens, ops = {}, []
    for k, mine in enumerate(ops_by_step):
        t0 = 11 * S_NS + k * 20 * MS
        meta = torch.full((rows,), 5, dtype=torch.int32)
        lens[id(meta)] = meta.numpy()
        spans.by_name["engine.step"].append(
            Span("engine.step", t0, t0 + 15 * MS, meta))
        ops += [(name, EPOCH + t0 + int(a * MS), EPOCH + t0 + int(b * MS))
                for name, a, b in mine]
    trace = DeviceTrace(EPOCH + 10 * S_NS, EPOCH + 20 * S_NS, ops)
    return bench.Context(cfg=cfg, rec=L.Record(t_open=1.0, t_close=20.0),
                         spans=spans, trace=trace,
                         traced_from_ns=10 * S_NS, block_size=16, lens=lens)


def test_gemm_roofline_takes_the_products_in_the_steps():
    # SMALL at 4 rows, each product bound by its bytes: weights 2 x
    # (64 x 64 x 2 + 64 x 32 x 2 + 64 x 128 x 3) + 64 x 100 = 80,128
    # elements; rows in 2 x 4 x (6 x 64 + 128) + 4 x 64, out 2 x 4 x
    # (64 + 32 + 32 + 64 + 128 + 128 + 64) + 4 x 100: 8,848
    least = (80_128 + 8_848) * 2 / 3.35e12
    assert dense_gemm.step_least_s(SMALL, 4, peaks.least_s) == \
        pytest.approx(least, rel=1e-12)
    ctx = traced_steps(SMALL, [
        [("nvjet_tst_64x64_64x13_4x1_v_bz_NNT", 0, 1.5),
         ("decode_attention_kernel", 1.5, 2.5),
         ("nvjet_tst_192x64_64x6_2x1_v_bz_splitK_NNT", 2.5, 2.9),
         ("void cublasLt::splitKreduce_kernel<32, 16>", 2.9, 3.0)],
        [("decode_attention_kernel", 0, 1)],        # no product: left out
        [("nvjet_tss_128x64", 1, 2)]])
    assert read("dense_gemm_decode_roofline", ctx) == pytest.approx(
        100 * 2 * least / 3e-3)


@pytest.mark.parametrize("case", ["no product", "no step", "routed"])
def test_gemm_roofline_finds_nothing(case):
    ops = [[("decode_attention_kernel", 0, 1)]] if case == "no product" \
        else [[("nvjet_tst_64x64", 0, 1)]]
    cfg = dict(SMALL, family="moe") if case == "routed" else SMALL
    ctx = traced_steps(cfg, [] if case == "no step" else ops)
    assert read("dense_gemm_decode_roofline", ctx) is None


# ---- mfu.prefill on a made-up tracer ----------------------------------

class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def prefill(tr, clock, t0, wall, rids):
    """One admitting tick at perf ``t0`` whose bucket of ``rids`` takes
    ``wall`` ns, a third each to its enqueue, splice and sync."""
    clock.t = t0
    tr.open_tick(1)
    tr.open("serve.admit", 1)
    tr.open("serve.prefill", 1)
    tr.open("serve.prefill.enqueue", 1)
    for part in ("serve.prefill.splice", "serve.prefill.sync"):
        clock.t += wall // 3
        tr.lap(part)
    clock.t = t0 + wall
    tr.close()
    tr.close((len(rids), 8, 0, tuple(rids)))
    tr.close((len(rids),))
    tr.close_tick((len(rids), 0, 0, len(rids)))


@pytest.fixture
def tracer(monkeypatch):
    clock = Clock()
    tr = T.Tracer(capacity=1 << 10, moe_capacity=1 << 4, clock=clock,
                  wall=lambda: EPOCH + clock.t)
    monkeypatch.setattr(T, "TRACER", tr)
    return tr, clock


def prefill_context(lens):
    """Window (1 s, 20 s], tracing from 10 s; request r's prompt lens[r]."""
    rec = L.Record(t_open=1.0, t_close=20.0)
    rec.sent = {r: L.Sent(r, prompt_len=n, max_new=8, t_submit=1.0)
                for r, n in lens.items()}
    return SimpleNamespace(rec=rec, traced_from_ns=10 * S_NS, cfg=SMALL)


def test_prefill_operations_at_each_prompts_length():
    # SMALL: 2 x (64 x 64 x 2 + 64 x 32 x 2 + 3 x 64 x 128) = 73,728
    # weights a token, 2 x 64 x 100 for the last token's logits, causal
    # attention 2 x 4 x 4 x 16 x p (p + 1) / 2
    def by_hand(p):
        return 2 * 73_728 * p + 12_800 + 256 * p * (p + 1)
    assert [by_hand(p) for p in (3, 4, 5)] == [458_240, 607_744, 757_760]
    assert step.prefill_flops(SMALL, [3, 5]) == 458_240 + 757_760
    # mistral-large-123b's 21 layers, one 100-token prompt
    assert step.prefill_flops(MISTRAL, [100]) == 5_819_323_219_968


def test_prefill_share_takes_the_window_before_tracing(tracer):
    tr, clock = tracer
    prefill(tr, clock, S_NS // 2, 3 * MS, [9])        # before the window
    prefill(tr, clock, 2 * S_NS, 2 * MS, [1, 2])
    prefill(tr, clock, 3 * S_NS, MS, [3])
    prefill(tr, clock, 4 * S_NS, MS, [77])            # a rid not sent
    prefill(tr, clock, 11 * S_NS, 5 * MS, [4])        # while tracing
    ctx = prefill_context({1: 3, 2: 5, 3: 4, 4: 7, 9: 6})
    want = 100 * (458_240 + 757_760 + 607_744) / 989.4e12 / 3e-3
    assert read("mfu.prefill", ctx) == pytest.approx(want, rel=1e-12)


def test_prefill_share_finds_nothing(tracer, monkeypatch):
    tr, clock = tracer
    ctx = prefill_context({1: 3})
    assert read("mfu.prefill", ctx) is None           # no prefill span
    prefill(tr, clock, 2 * S_NS, 2 * MS, [1])
    assert read("mfu.prefill", ctx) is not None
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read("mfu.prefill", ctx) is None           # no tracer


# ---- the cell --------------------------------------------------------------

def test_the_dense_cell_reports_no_routed_metric():
    cell = S.resolve_cell(S.load_spec(), CELL)
    names = {m.name for m in cell.per_layer}
    assert "gmm_decode_roofline" not in names
    assert "moe_drop_share" not in names
    assert {"dense_gemm_decode_roofline", "mfu.prefill",
            "decode_graph_share", "mfu.decode"} <= names
    assert {m.name for m in cell.end_to_end} == {
        "output_tok_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"}
    assert cell.config["family"] == "dense" and cell.chips == 1
    assert {"gap", "gap_p90"} <= set(cell.limits)
    assert cell.limits["sample"]["per_request"] == 100


TINY = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 32, "d_ff": 192, "vocab_size": 256, "dtype": "float32"}
MIX = {"clients": 4, "cache_len": 256,
       "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                  "min": 8, "max": 64},
       "output": {"dist": "uniform", "min": 4, "max": 24}}


def altered_token(bundle, engine):
    """Every decode step serves each row's second-best token."""
    decode = bundle.decode_paged

    def call(params, cache, batch):
        logits, new = decode(params, cache, batch)
        logits = logits.clone()
        logits.scatter_(1, logits.argmax(-1, keepdim=True), float("-inf"))
        return logits, new
    bundle.decode_paged = call


@pytest.mark.parametrize("fault", [None, altered_token],
                         ids=["sound", "altered_token"])
def test_the_cells_limits_judge_a_reduced_run(fault):
    cell = S.resolve_cell(S.load_spec(), CELL)
    out = bench.run_cell(cell, 3_000_000_019, 0.6, fault is None,
                         t_start=time.perf_counter(), device="cpu",
                         config=TINY, mix=MIX, patch=fault)
    assert out["compared_tokens"] > 0
    assert set(out["checks"]) == {"gap", "gap_p90"}
    assert out["correct"] is (fault is None)
    if fault is None:
        # traced: the prefill share reads the program's spans (a CPU
        # number, no device metric); the products' roofline finds no
        # device trace
        assert np.isfinite(out["metrics"]["mfu.prefill"]["value"])
        assert "dense_gemm_decode_roofline" not in out["metrics"]
