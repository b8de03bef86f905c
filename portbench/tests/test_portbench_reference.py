"""The plain references against the port's plain path at a reduced size
(float32 on the CPU).  The test imports both; the references import
neither the port nor anything of it."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench.harness import bench
from portbench.harness.weights import draw_params
from portbench.reference import dense as RD
from portbench.reference import moe as RM

TINY = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 32, "d_ff": 192, "moe_d_ff": 96, "vocab_size": 256,
        "dtype": "float32"}
TOL = dict(rtol=1e-4, atol=1e-4)


def setup(arch: str, **over):
    conf = dict(bench.S.load_json(bench.S.BENCH_DIR / "configs"
                                  / f"{arch}.json"), **TINY, **over)
    mcfg = bench.model_config(conf)
    params = draw_params(conf, 1234, torch.device("cpu"), torch.float32)
    return conf, mcfg, params


@pytest.mark.parametrize("arch,ref", [("mistral-large-123b", RD),
                                      ("dbrx-132b", RM)])
def test_forward_matches_the_port(arch, ref):
    from repro_torch.models import transformer as M
    conf, mcfg, params = setup(arch)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 256, (3, 40), generator=g)
    with torch.no_grad():
        want, _ = M.lm_forward(params, mcfg, tokens=tokens)
        got, _ = ref.run(params, conf, [ref.Row(tokens=t) for t in tokens])
    torch.testing.assert_close(got, want.reshape(-1, 256), **TOL)


def test_capacity_drops_match_the_port():
    from repro_torch.models import moe as M
    conf, mcfg, params = setup("dbrx-132b", capacity_factor=0.5)
    lp = params["layers"][0]
    x = torch.randn(2, 48, 128, generator=torch.Generator().manual_seed(3))
    t = 96
    assert RM.capacity(t, conf) == M.expert_capacity(t, mcfg) == 16
    with torch.no_grad():
        want, _ = M.moe_block(lp["moe"], x, mcfg)
        got = RM.experts(lp, x.reshape(-1, 128), conf, "f32")
    torch.testing.assert_close(got, want.reshape(-1, 128), **TOL)
    # the cut is real: at the unbounded capacity the output differs
    conf_all = dict(conf, capacity_factor=8.0)
    free = RM.experts(lp, x.reshape(-1, 128), conf_all, "f32")
    assert (free - got).abs().max() > 1e-2


@pytest.mark.parametrize("arch,ref", [("mistral-large-123b", RD),
                                      ("dbrx-132b", RM)])
def test_decode_from_a_past_matches_the_port(arch, ref):
    from repro_torch.models import transformer as M
    conf, mcfg, params = setup(arch)
    g = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, 256, (2, 30), generator=g)
    nxt = torch.randint(0, 256, (2, 1), generator=g)
    with torch.no_grad():
        _, cache = M.lm_prefill(params, mcfg, tokens=prompt, cache_len=64)
        want, _ = M.lm_decode_step(params, cache, nxt, mcfg)
        rows = [ref.Row(tokens=nxt[b], start=30,
                        past=lambda i, b=b: (cache["k"][i, b, :30],
                                             cache["v"][i, b, :30]))
                for b in range(2)]
        got, kv = ref.run(params, conf, rows, keep_kv=True)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(kv[1][1][0][0], cache["k"][1, 1, 30], **TOL)


@pytest.mark.parametrize("arch,ref", [("mistral-large-123b", RD),
                                      ("dbrx-132b", RM)])
def test_decode_steps_followed_from_the_cache_match_the_port(arch, ref):
    from repro_torch.models import transformer as M
    conf, mcfg, params = setup(arch)
    g = torch.Generator().manual_seed(11)
    prompt = torch.randint(0, 256, (1, 30), generator=g)
    toks = torch.randint(0, 256, (3,), generator=g)
    with torch.no_grad():
        _, cache = M.lm_prefill(params, mcfg, tokens=prompt, cache_len=64)
        want = []
        for t in toks:
            logits, cache = M.lm_decode_step(params, cache, t.view(1, 1),
                                             mcfg)
            want.append(logits[0])
        row = ref.Row(tokens=toks, start=30, past_only=True,
                      past=lambda i: (cache["k"][i, 0, :33],
                                      cache["v"][i, 0, :33]))
        # one token a step: rows of one call cannot lose a pair
        free = dict(conf, capacity_factor=float(conf.get("n_experts", 1)))
        got, kv = ref.run(params, free, [row], keep_kv=True)
    torch.testing.assert_close(got, torch.stack(want), **TOL)
    torch.testing.assert_close(kv[0][1][1], cache["v"][1, 0, 30:33], **TOL)


def test_the_control_rounds_to_float8():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    q = RD.fp8(x, -1)
    assert 0.01 < float((q - x).norm() / x.norm()) < 0.1
    assert torch.equal(RD.fp8(q, -1), q)


def test_weights_are_drawn_from_the_seed():
    conf, _, _ = setup("dbrx-132b")
    a = draw_params(conf, 2 ** 40 + 1, torch.device("cpu"), torch.float32)
    b = draw_params(conf, 2 ** 40 + 1, torch.device("cpu"), torch.float32)
    c = draw_params(conf, 2 ** 40 + 2, torch.device("cpu"), torch.float32)
    assert torch.equal(a["layers"][1]["moe"]["down"],
                       b["layers"][1]["moe"]["down"])
    assert not torch.equal(a["embed"], c["embed"])
    assert dataclasses.is_dataclass(bench.model_config(conf))
