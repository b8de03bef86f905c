"""chip_smoke.py's serving phases, rehearsed on the CPU at toy size.

The script itself refuses to run without a card; its serve phases take a
device and the reduced config so that their control flow (requests, launch
accounting, the kernel-vs-plain logits check, the oracle share, the
paged-equals-dense gate, capacity and the router's failover) is exercised
here before any chip time is spent.  Timings are stubbed: CUDA events exist
only on the card.
"""
import re
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


def _counted(name, module=ops, ref_name=None):
    """The CPU path launches nothing: count its calls as launches."""
    op = getattr(module, name)
    ref = getattr(module, ref_name or f"{name}_ref")

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
        mp.setattr(attention, "flash_attention",
                   _counted("flash_attention", flash_ops))
        mp.setattr(ops.decode_attention, "launches", 0)
        mp.setattr(ops.paged_decode_attention, "launches", 0)
        mp.setattr(flash_ops.flash_attention, "launches", 0)
        result = chip_smoke.phase_serve(torch, device="cpu", reduced=True)
        yield result, lines


def test_serve_phase_runs_on_cpu(served):
    (launches, path, out), lines = served
    text = "\n".join(lines)
    assert "16 requests" in text and "rel_err=0 " in text
    assert "flash_attention 48 (= 16 x 3)" in text
    assert "[serve] prefill A/B in this process" in text
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


@pytest.fixture
def ecg_patched():
    """Phases 8-9 on the CPU: CUDA timing stubbed, conv wrapper calls
    counted as launches (the CPU path launches nothing)."""
    import repro_torch.hwlib.layers as layers_mod
    from repro_torch.kernels.conv1d import ops as conv_ops
    lines = []

    def counted(*args, **kw):
        conv_ops.dwsep_conv1d.launches += 1
        return conv_ops.dwsep_conv1d_ref(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
        mp.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
        mp.setattr(layers_mod, "dwsep_conv1d", counted)
        mp.setattr(conv_ops.dwsep_conv1d, "launches", 0)
        yield lines


def test_conv_kernel_phase_runs_on_cpu(ecg_patched):
    """Phase 8 at small shapes: kernel (here the plain path) vs plain, and
    the two-call library equivalent agrees with both in f32 (in bf16 the
    library rounds its depthwise result to bf16 between the calls)."""
    chip_smoke.phase_conv_kernels(torch, device="cpu", shapes=[
        (2, 50, 16, 1, 2, 1), (1, 33, 2, 3, 130, 1), (3, 41, 8, 7, 4, 4)])
    assert len(ecg_patched) == 6
    f32 = [line for line in ecg_patched if " float32:" in line]
    assert len(f32) == 3
    for line in f32:
        assert float(re.search(r"library err ([0-9.e+-]+)", line)[1]) < 1e-4


def test_conv_bound_counts_bytes_and_flops():
    x = torch.empty(256, 3744, 32)
    out = torch.empty(256, 3738, 32)
    ms, by = chip_smoke.conv_bound_ms(x, torch.empty(7, 32),
                                      torch.empty(32, 32), out)
    want_bytes = (x.numel() + 7 * 32 + 32 * 32 + 32 + out.numel()) * 4
    assert by == "bytes"
    assert ms == pytest.approx(want_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_ecg_phase_runs_on_cpu(ecg_patched):
    """Phase 9 at toy size (40 records, 3 steps): the launch gate, the
    kernel-vs-plain logits gate, the replicas' failover and the rates."""
    launches, path, out = chip_smoke.phase_ecg(
        torch, device="cpu", n_samples=40, train_steps=3, train_batch=8,
        batches=(4, 16), timed_steps=2)
    text = "\n".join(ecg_patched)
    # 6 convs x (2 BN re-estimation + 1 eval chunk + 1 profile + 2 + 1
    # single-winner batches + 2 + 1 replicated batches) for 8 val records
    assert launches == 6 * (2 + 1 + 1 + 3 + 3)
    assert "'failovers': 1" in text
    assert out["logit_err"] <= chip_smoke.ECG_LOGIT_TOL
    assert path["err"] == 0.0 and path["bound_by"] in ("bytes",
                                                       "operations")
    assert out["rates"]["train_steps_per_s"] > 0
    assert out["winner"].input_length == 3750
    assert "dw7s1c32 dw7s1c32 dw5s2c32 dw5s2c32 mp4 dw3s1c32 dw3s2c32" \
        in text


def test_ecg_phase_gates_on_launches(ecg_patched, monkeypatch):
    """A conv that skips the kernel on the path fails the launch gate."""
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.hwlib import layers as layers_mod
    monkeypatch.setattr(layers_mod, "dwsep_conv1d", conv_ops.dwsep_conv1d_ref)
    with pytest.raises(RuntimeError, match="dwsep_conv1d launched 0 times"):
        chip_smoke.phase_ecg(torch, device="cpu", n_samples=20,
                             train_steps=1, train_batch=4, batches=(4,),
                             timed_steps=1)


def test_paged_serve_phase_gates_on_flash_launches(served):
    """A prefill that skips the flash kernel fails phase 5's launch gate."""
    (_, _, out), _ = served
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention",
                   flash_ops.flash_attention_ref)
        with pytest.raises(RuntimeError,
                           match="flash_attention launched 0 times"):
            chip_smoke.phase_paged_serve(torch, out["model"], out["tokens"],
                                         device="cpu", reduced=True)


@pytest.mark.parametrize("dtype,length,c_in,offset,path", [
    (torch.float32, 3750, 2, 0, "cp.async16"),   # the ECG input layer
    (torch.float32, 3744, 32, 0, "cp.async16"),
    (torch.bfloat16, 3750, 2, 0, "cp.async4"),   # records of 15,000 bytes
    (torch.bfloat16, 3744, 32, 0, "cp.async16"),
    (torch.float32, 3744, 32, 1, "cp.async4"),   # x off a 16-byte boundary
    (torch.bfloat16, 33, 1, 0, "loads"),         # records of 66 bytes
    (torch.bfloat16, 3744, 32, 1, "loads"),      # x off a 4-byte boundary
])
def test_conv_path_names_the_window_copy(dtype, length, c_in, offset, path):
    """conv_path mirrors csrc/dwsep_conv1d.cu's rule: the windows go by
    cp.async in the largest unit (16 or 4 bytes) on which every record's
    rows start, else by plain loads."""
    x = torch.zeros(2 * length * c_in + offset, dtype=dtype)[offset:]
    assert chip_smoke.conv_path(x.view(2, length, c_in)) == path
