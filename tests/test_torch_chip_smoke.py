"""chip_smoke.py's serving phases, rehearsed on the CPU at toy size.

The script itself refuses to run without a card; its serve phases take a
device and the reduced config so that their control flow (requests, launch
accounting, the kernel-vs-plain logits check, the oracle share, the
paged-equals-dense gate, capacity and the router's failover) is exercised
here before any chip time is spent.  Timings are stubbed: CUDA events exist
only on the card.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402


def _counted(name):
    """The CPU path launches nothing: count its calls as launches."""
    op, ref = getattr(ops, name), getattr(ops, f"{name}_ref")

    def call(*args):
        op.launches += 1
        return ref(*args)
    return call


@pytest.fixture(scope="module")
def served():
    """Phase 4 at toy size on the CPU, with counted attention calls; the
    patches stay in place for the phases that follow it.  Returns the
    phase's result and the list the phases log into."""
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
        mp.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
        for name in ("decode_attention", "paged_decode_attention"):
            mp.setattr(attention, name, _counted(name))
        mp.setattr(ops.decode_attention, "launches", 0)
        mp.setattr(ops.paged_decode_attention, "launches", 0)
        result = chip_smoke.phase_serve(torch, device="cpu", reduced=True)
        yield result, lines


def test_serve_phase_runs_on_cpu(served):
    (launches, path, out), lines = served
    text = "\n".join(lines)
    assert "16 requests" in text and "rel_err=0 " in text
    assert launches > 0 and launches % 3 == 0        # steps x 3 layers
    assert path["bound_by"] == "bytes" and path["err"] == 0.0
    assert len(path["kv_len"]) == 8
    assert len(out["tokens"]) == 16
    assert out["model"][0].name == "qwen3-4b-smoke"


def _phase(served, fn, *args, **kw):
    """Run a later phase on phase 4's model; returns (result, its log)."""
    (_, _, out), lines = served
    n = len(lines)
    result = fn(torch, out["model"], *args, device="cpu", **kw)
    return result, "\n".join(lines[n:])


def test_paged_serve_phase_runs_on_cpu(served):
    """Phase 5: launches = steps x layers, and the paged engine's tokens
    equal phase 4's dense engine's for all 16 requests (the gate raises
    otherwise)."""
    (_, _, out), _ = served
    (launches, path), text = _phase(served, chip_smoke.phase_paged_serve,
                                    out["tokens"], reduced=True)
    assert "equal to the dense engine's for 16/16 requests" in text
    assert launches > 0 and launches % 3 == 0
    assert path["bound_by"] == "bytes" and path["err"] == 0.0
    assert path["blocks_used"] > 0 and len(path["kv_len"]) == 8


def test_paged_serve_phase_gates_on_dense_tokens(served):
    (_, _, out), _ = served
    wrong = {rid: toks[:-1] + [toks[-1] + 1]
             for rid, toks in out["tokens"].items()}
    with pytest.raises(RuntimeError, match="equal the dense engine's"):
        chip_smoke.phase_paged_serve(torch, out["model"], wrong,
                                     device="cpu", reduced=True)


def test_capacity_phase_runs_on_cpu(served):
    """Phase 6 at toy size: 32 slots over 64 blocks of 16."""
    stats, text = _phase(served, chip_smoke.phase_capacity, n_blocks=64,
                         cache_len=128, max_prompt=112, median_prompt=16)
    assert stats["peak_concurrency"] > 8
    assert stats["peak_blocks_used"] <= 64
    assert "[capacity] 48 long-tail requests" in text


def test_router_phase_runs_on_cpu(served):
    """Phase 7: on the CPU the failed-over requests decode as before, so
    both runs' tokens are equal."""
    (clean, lost), text = _phase(served, chip_smoke.phase_router,
                                 reduced=True)
    assert clean == lost
    assert "'quarantined': [1]" in text and "16/16 requests" in text
