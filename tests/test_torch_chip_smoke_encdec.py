"""chip_smoke.py's unmasked flash cases of phase 3c and its phases 15-16
(whisper-tiny and qwen2-vl-2b), rehearsed on the CPU at toy size.

As in tests/test_torch_chip_smoke_hybrid.py: the script refuses to run
without a card, so its phases take a device, the reduced configs and a
small run, and their control flow (kernel vs plain, launch gates by mask,
each flash launch against its plain version, the logits gates, row 0
against the same request alone, the loss gates) is exercised here, and
each gate is broken once.  Timings are stubbed: CUDA events exist only on
the card; the CPU path launches nothing, so each wrapper's calls are
counted as launches (the flash op's by mask too).
"""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import repro_torch.kernels.flash_attention as flash_pkg  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (a fixture)

ENCDEC_RUN = dict(batch=2, frames=40, prompt=3, cache_len=16, steps=3,
                  train_steps=4)
VLM_RUN = dict(batch=2, seq=40, text=4, grid=4, steps=3, train_batch=4,
               train_seq=32, train_steps=4)
# what a reduced model's loss falls by in 4 steps on one fixed batch (the
# published configs' gate, TRAIN_MIN_FALL, is for 10 steps at full width)
MIN_FALL = 0.01


def _flash(shift=0.0, mask=None):
    """The flash op's CPU path, counted as a launch under its mask (or
    ``mask`` whatever the call's), its output moved by ``shift`` where
    unmasked."""
    op = flash_ops.flash_attention

    def call(q, k, v, causal=True):
        op.launches += 1
        op.launches_by_mask[mask or ("causal" if causal else "full")] += 1
        out = flash_ops.flash_attention_ref(q, k, v, causal)
        return out if causal else out + shift
    return call


def _decode(scale=1.0):
    op = ops.decode_attention

    def call(*args):
        op.launches += 1
        return ops.decode_attention_ref(*args) * scale
    return call


@pytest.fixture
def patched():
    """CUDA timing stubbed, both attention ops counted; the phases log
    into the returned list."""
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
        mp.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
        mp.setattr(attention, "flash_attention", _flash())
        mp.setattr(attention, "decode_attention", _decode())
        yield lines


def _encdec(**kw):
    return chip_smoke.phase_encdec(torch, device="cpu", reduced=True,
                                   run=ENCDEC_RUN, min_fall=MIN_FALL, **kw)


def _vlm(**kw):
    return chip_smoke.phase_vlm(torch, device="cpu", reduced=True,
                                run=VLM_RUN, min_fall=MIN_FALL, **kw)


def test_flash_full_kernel_phase_runs_on_cpu(patched):
    """Phase 3c's unmasked cases at small shapes: kernel (here the plain
    path) vs plain, and SDPA agrees with both in f32."""
    out = chip_smoke.phase_flash_full_kernels(torch, device="cpu", cases={
        "cross": (2, 4, 40, 6, 6, 64, "float32"),
        "ragged": (1, 9, 70, 4, 2, 32, "bfloat16")})
    assert set(out) == {"cross", "ragged"}
    assert all(r["err"] == 0 for r in out.values())
    assert out["cross"]["lib_err"] < 1e-5
    assert all("no mask" in line for line in patched)


def test_flash_flops_and_bound_by_mask():
    q = torch.empty(8, 4, 6, 64, dtype=torch.bfloat16)
    k = torch.empty(8, 1500, 6, 64, dtype=torch.bfloat16)
    assert chip_smoke.flash_flops(q, k, causal=False) == 4 * 64 * 6 * 8 \
        * 4 * 1500
    # top-left causal: query i sees min(i + 1, Sk) keys
    assert chip_smoke.flash_flops(q, k) == 4 * 64 * 6 * 8 * (1 + 2 + 3 + 4)
    assert chip_smoke.flash_flops(k, q) == 4 * 64 * 6 * 8 * (
        10 + 4 * (1500 - 4))
    assert chip_smoke.flash_flops(k) == chip_smoke.flash_flops(k, k)
    ms, by = chip_smoke.flash_bound_ms(q, k, causal=False)
    assert by == "bytes"
    assert ms == pytest.approx((2 * q.numel() + 2 * k.numel()) * 2
                               / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_vlm_positions_lay_out_text_grid_text():
    pos = chip_smoke.vlm_positions(torch, 2, 2, 3, 13, "cpu")
    assert pos.shape == (3, 2, 13) and pos.dtype == torch.int32
    assert pos[:, 1].tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 5, 6],
                                  [0, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6],
                                  [0, 1, 2, 3, 4, 2, 3, 4, 2, 3, 4, 5, 6]]


def test_encdec_phase_runs_on_cpu(patched):
    """Phase 15 on reduced whisper-tiny (3 + 2 layers): flash launches =
    3 + 2 x 2 a prefill (5 unmasked, 2 causal), decode launches = 2 x 2 a
    step, the per-launch and logits gates, row 0 alone, the loss gates."""
    out = _encdec()
    assert out["counts"]["flash_attention"] == 7
    assert out["masks"] == {"causal": 2, "full": 5}
    assert out["decode_launches"] == 4 * ENCDEC_RUN["steps"]
    assert out["flash_err"] == 0.0
    assert out["prefill_rel"] == 0.0 and out["decode_rel"] == 0.0
    assert out["cross"]["err"] == 0.0 and out["cross"]["bound_by"] == "bytes"
    assert out["flash_rel"] == 0.0
    assert out["one_equal"] == ENCDEC_RUN["steps"] + 1
    losses = out["train"]["losses"]
    assert abs(losses[0] - math.log(512)) < 0.5 and losses[-1] < losses[0]
    text = "\n".join(patched)
    assert "equal a one-request run at 4 of 4 positions, and the request " \
        "alone in the batch of 2 (other rows empty): True" in text
    # the profiler sees no device kernel on the CPU
    assert out["profile"] == {}


def test_vlm_phase_runs_on_cpu(patched):
    """Phase 16 on reduced qwen2-vl-2b (3 layers): 3 causal flash launches
    a prefill, 3 decode launches a step, the gates, the loss falls."""
    out = _vlm()
    assert out["counts"]["flash_attention"] == 3
    assert out["decode_launches"] == 3 * VLM_RUN["steps"]
    assert out["flash_err"] == 0.0 and out["flash_rel"] == 0.0
    assert out["prefill_rel"] == 0.0 and out["decode_rel"] == 0.0
    assert out["train"]["losses"][-1] < out["train"]["losses"][0]


@pytest.mark.parametrize("phase", ["encdec", "vlm"])
@pytest.mark.parametrize("gate,swap,match", [
    ("flash_launches", ("flash_attention", flash_ops.flash_attention_ref),
     "flash_attention launched 0 times"),
    ("decode_launches", ("decode_attention", ops.decode_attention_ref),
     "decode_attention launched 0 times"),
    ("flash_output", ("flash_attention", _flash(shift=0.5)),
     "disagrees with its plain version"),
    ("logits", ("decode_attention", _decode(scale=1.5)),
     "decode step logits, kernels vs plain"),
])
def test_phases_gate_on_launches_kernels_and_logits(patched, phase, gate,
                                                    swap, match):
    """A prefill or decode step that skips its kernel, a flash launch that
    disagrees with its plain version, and a decode kernel that moves the
    logits each fail the phase (the VLM's flash calls are all causal:
    the moved unmasked output cannot show there)."""
    if phase == "vlm" and gate == "flash_output":
        swap = ("flash_attention", lambda q, k, v, causal=True:
                _flash()(q, k, v, causal) + 0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, *swap)
        with pytest.raises(RuntimeError, match=match):
            _encdec() if phase == "encdec" else _vlm()


def test_encdec_phase_gates_on_the_mask(patched):
    """A prefill whose launches all count as causal fails the mask gate."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention", _flash(mask="causal"))
        with pytest.raises(RuntimeError, match="by mask"):
            _encdec()


@pytest.mark.parametrize("run,match", [(2, "a one-request run"),
                                       (3, "alone in the batch")])
def test_encdec_phase_gates_on_row_0_alone(patched, run, match):
    """Row 0's tokens must equal a one-request run's (greedy run 2) and
    the same request's alone in the batch (run 3)."""
    real = chip_smoke.greedy_run
    calls = []

    def greedy(torch_, bundle, params, batch, steps):
        toks, cache, ms = real(torch_, bundle, params, batch, steps)
        calls.append(1)
        if len(calls) == run:
            toks = toks.clone()
            toks[0, -1] = (toks[0, -1] + 1) % 512
        return toks, cache, ms
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "greedy_run", greedy)
        with pytest.raises(RuntimeError, match=match):
            _encdec()


def _shrunk_flash(q, k, v, causal=True):
    """The plain version, every output 1% smaller: what a kernel that let
    ~1% of the softmax's weight fall on zero-filled keys would give."""
    return flash_ops.flash_attention_ref(q, k, v, causal) * 0.99


_shrunk_flash.launches_by_path = dict.fromkeys(flash_ops.PATHS, 0)
_shrunk_flash.launches_by_mask = dict.fromkeys(flash_ops.MASKS, 0)


@pytest.mark.parametrize("check", ["flash_case_ms", "check_flash_calls"])
def test_flash_checks_gate_normwise(patched, check):
    """An output 1% small passes allclose at TOL["bfloat16"] at values of
    ~0.1 but not FLASH_NORM_TOL, in phase 3's case check and in the
    phases' per-launch check alike."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 2, 64, generator=gen).to(torch.bfloat16)
               for n in (4, 200, 200))
    got, want = _shrunk_flash(q, k, v, False), \
        flash_ops.flash_attention_ref(q, k, v, False)
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(RuntimeError, match="normwise"):
        if check == "flash_case_ms":
            mp.setattr(flash_pkg, "flash_attention", _shrunk_flash)
            chip_smoke.flash_case_ms(torch, [(q, k, v, False)])
        else:
            chip_smoke.check_flash_calls(torch, "[t]", [(q, k, v, False,
                                                         got)], "bfloat16")


@pytest.mark.parametrize("phase", ["encdec", "vlm"])
def test_phases_gate_on_the_loss(patched, phase):
    """A loss that does not fall by the margin fails; so does a first
    whisper loss off ln(vocab), and kernels launched under a gradient."""
    fn = chip_smoke.phase_encdec if phase == "encdec" \
        else chip_smoke.phase_vlm
    run = ENCDEC_RUN if phase == "encdec" else VLM_RUN
    with pytest.raises(RuntimeError, match="training loss"):
        fn(torch, device="cpu", reduced=True, run=run, min_fall=100.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "_grad_taken", lambda *ts: False)
        with pytest.raises(RuntimeError, match="training launched kernels"):
            fn(torch, device="cpu", reduced=True, run=run,
               min_fall=MIN_FALL)
    if phase == "encdec":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(chip_smoke, "TRAIN_FIRST_LOSS_TOL", -1.0)
            with pytest.raises(RuntimeError, match="ln vocab"):
                _encdec()
