"""The dense reference against the port's plain path at mistral-large-123b's
grouping, 12 query heads to a key/value head (96 over 8 there, 24 over 2
here), at a reduced size in float32 on the CPU."""
from __future__ import annotations

import pytest
import torch

from portbench.harness import bench
from portbench.harness.weights import draw_params
from portbench.reference import dense as RD

GQA12 = {"n_layers": 2, "d_model": 192, "n_heads": 24, "n_kv_heads": 2,
         "head_dim": 32, "d_ff": 256, "vocab_size": 256, "dtype": "float32"}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    conf = dict(bench.S.load_json(bench.S.BENCH_DIR / "configs"
                                  / "mistral-large-123b.json"), **GQA12)
    mcfg = bench.model_config(conf)
    assert mcfg.n_heads // mcfg.n_kv_heads == 12
    params = draw_params(conf, 4321, torch.device("cpu"), torch.float32)
    return conf, mcfg, params


def test_forward_matches_the_port(model):
    from repro_torch.models import transformer as M
    conf, mcfg, params = model
    tokens = torch.randint(0, 256, (3, 40),
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want, _ = M.lm_forward(params, mcfg, tokens=tokens)
        got, _ = RD.run(params, conf, [RD.Row(tokens=t) for t in tokens])
    torch.testing.assert_close(got, want.reshape(-1, 256), **TOL)


def test_decode_steps_followed_from_the_cache_match_the_port(model):
    from repro_torch.models import transformer as M
    conf, mcfg, params = model
    g = torch.Generator().manual_seed(11)
    prompt = torch.randint(0, 256, (2, 30), generator=g)
    toks = torch.randint(0, 256, (2, 3), generator=g)
    with torch.no_grad():
        _, cache = M.lm_prefill(params, mcfg, tokens=prompt, cache_len=64)
        want = []
        for t in toks.T:
            logits, cache = M.lm_decode_step(params, cache, t.view(2, 1),
                                             mcfg)
            want.append(logits)
        rows = [RD.Row(tokens=toks[b], start=30, past_only=True,
                       past=lambda i, b=b: (cache["k"][i, b, :33],
                                            cache["v"][i, b, :33]))
                for b in range(2)]
        got, kv = RD.run(params, conf, rows, keep_kv=True)
    torch.testing.assert_close(got, torch.stack(want, 1).reshape(6, 256),
                               **TOL)
    torch.testing.assert_close(kv[1][1][0], cache["k"][1, 1, 30:33], **TOL)
