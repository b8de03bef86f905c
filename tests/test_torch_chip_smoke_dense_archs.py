"""chip_smoke.py's phase 19 (granite-34b and mistral-large-123b cut in
depth), rehearsed on the CPU at the reduced configs.

The script refuses to run without a card, so the phase takes a device,
the reduced config, the cache length and the prompt lengths.  Here it
runs through ``dense_child`` (its JSON written and read back, as the card
run's parent reads it), with each attention wrapper's CPU calls counted as
launches; then ``phase_dense_archs`` and the ``kernels`` line read those
results.  Each gate is broken once: a wrapper that skips its kernel, and
wrappers whose outputs are wrong.  Timings are stubbed: CUDA events exist
only on the card.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (a fixture)

ARCHS = list(chip_smoke.DENSE_LAYERS)
TOY = dict(reduced=True, cache_len=64, lengths=(4, 40))
WRAPPERS = {"decode_attention": ops, "paged_decode_attention": ops,
            "flash_attention": flash_ops}


def _counted(name, wrong: float = 0.0):
    """A wrapper whose CPU calls count as launches of its kernel; its
    output is the plain version's, plus ``wrong``."""
    module = WRAPPERS[name]
    op, ref = getattr(module, name), getattr(module, f"{name}_ref")

    def call(*args):
        op.launches += 1
        return ref(*args) + wrong
    return call


def _patched(mp, lines, **wrong):
    mp.setattr(chip_smoke, "log", lines.append)
    mp.setattr(torch.cuda, "synchronize", lambda *a: None)
    mp.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
    mp.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
    for name in WRAPPERS:
        mp.setattr(attention, name, _counted(name, wrong.get(name, 0.0)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each arch's phase 19 through dense_child, and its log lines."""
    out, lines = {}, []
    for arch in ARCHS:
        path = tmp_path_factory.mktemp("dense") / f"{arch}.json"
        with pytest.MonkeyPatch.context() as mp:
            _patched(mp, lines)
            assert chip_smoke.dense_child(arch, str(path), "cpu", **TOY) == 0
        out[arch] = json.loads(path.read_text())
    return out, "\n".join(lines)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_arch_phase_runs_on_cpu(results, arch):
    """Reduced granite-34b (MQA) and mistral-large-123b (3 layers each):
    the launch gates of both engines, paged tokens = dense tokens, the
    logits gates with the residual stream's drift by layer, and each
    flash launch of one prefill."""
    r = results[0][arch]
    assert r["layers"] == 3 and r["published_layers"] == 88
    for kind, decode, other in (
            ("dense", "decode_attention", "paged_decode_attention"),
            ("paged", "paged_decode_attention", "decode_attention")):
        run = r[kind]
        s, c = run["stats"], run["counts"]
        assert s["decode_steps"] > 0 and s["prefill_calls"] > 0
        assert c[decode] == 3 * s["decode_steps"] and c[other] == 0
        assert c["flash_attention"] == 3 * s["prefill_calls"]
        assert run["step_rel"] == 0.0 and run["step_drift"] == [0.0] * 3
    n = chip_smoke.DENSE_REQUESTS
    assert r["requests"] == n and r["paged"]["same_as_dense"] == n
    assert r["paged"]["stats"]["n_blocks"] == 8 * 64 // 16
    assert r["prefill_rel"] == 0.0 and r["prefill_drift"] == [0.0] * 3
    assert r["prompt"] == 40           # the burst's longest, of 16
    assert r["flash"]["err"] == 0.0 and r["flash"]["rel"] == 0.0
    assert r["flash"]["bound_by"] in ("bytes", "operations")
    assert 0 <= r["oracle_same"] <= n
    assert r["n_params"] > 0 and r["n_bytes"] == 4 * r["n_params"]
    text = results[1]
    assert f"[{arch} paged] engine: {n} requests" in text
    assert f"tokens equal to the dense engine's for {n}/{n} requests" in text
    assert "residual stream kernels vs plain after layer 1: 0, 2: 0, 3: 0" \
        in text
    assert f"[kernel] flash_attention at one 40-token {arch} prefill's 3" \
        in text


def test_phase_19_reads_its_children(results, monkeypatch):
    """phase_dense_archs runs one child an arch, with the arch on its
    command line; the kernels line gains each arch's launches and the
    flash kernel's times at its prefill."""
    by_arch, _ = results
    calls, lines = [], []

    def child(flag, tag, *args, echo):
        calls.append((flag, args, echo))
        return by_arch[args[0]]
    monkeypatch.setattr(chip_smoke, "_child", child)
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    assert chip_smoke.phase_dense_archs() == by_arch
    assert calls == [("--phase-19", (arch,), "") for arch in ARCHS]
    assert sum(line.startswith("[dense] ") for line in lines) == 3
    kernels = [{"name": name, "library": ""} for name in WRAPPERS]
    chip_smoke.dense_arch_entries(kernels, by_arch)
    decode, paged, flash = kernels
    for arch, r in by_arch.items():
        assert decode["dense_arch_launches"][arch] == \
            r["dense"]["counts"]["decode_attention"] > 0
        assert paged["dense_arch_launches"][arch] == \
            r["paged"]["counts"]["paged_decode_attention"] > 0
        assert flash["dense_arch_launches"][arch] == \
            r["dense"]["counts"]["flash_attention"] > 0
        assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "rel_err"} <= set(
                    flash["dense_arch_prefill"][arch])
    assert all("phase 19" in k["library"] for k in kernels)


@pytest.mark.parametrize("wrong,match", [
    ({"decode_attention": 1.0}, "decode-step logits"),
    ({"paged_decode_attention": 1.0},
     "paged engine tokens|decode-step logits"),
    ({"flash_attention": 1.0}, "prefill logits"),
], ids=["decode", "paged", "flash"])
def test_dense_arch_phase_fails_on_a_wrong_kernel(wrong, match):
    """A kernel whose output is off by one fails the phase: the dense
    decode kernel the decode-step logits gate, the paged one the token
    gate (or its logits gate), flash the prefill logits gate."""
    with pytest.MonkeyPatch.context() as mp:
        _patched(mp, [], **wrong)
        with pytest.raises(RuntimeError, match=match):
            chip_smoke.phase_dense_arch(torch, "cpu", arch=ARCHS[0], **TOY)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_dense_arch_phase_gates_on_launches(name):
    """A path that skips a kernel fails the launch gate."""
    with pytest.MonkeyPatch.context() as mp:
        _patched(mp, [])
        mp.setattr(attention, name, getattr(WRAPPERS[name], f"{name}_ref"))
        with pytest.raises(RuntimeError, match=f"{name} launched 0 times"):
            chip_smoke.phase_dense_arch(torch, "cpu", arch=ARCHS[1], **TOY)
