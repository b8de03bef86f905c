"""chip_smoke.py's phase 14 (training), rehearsed on the CPU at toy size.

The script refuses to run without a card, so each part takes a device
(and phase 14b its run's size); the control flow and every gate (the
gmm backward against autograd through gmm_ref, the launcher's clean and
failed runs, the eval step's flash launches, the MoE launch count and the
card-vs-CPU step) run here first.  The CPU path launches no kernel, so
each plain-version call of a wrapper is counted as its launch through the
same counter the wrappers use.  Timings need the card and are skipped.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import repro_torch.models.attention as attention_mod  # noqa: E402
from repro_torch.kernels._launches import count_launch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (a fixture)

TOY_GMM = [(4, 32, 64, 48, "bfloat16"), (2, 17, 100, 72, "float32")]
TOY_RUN = dict(steps=10, batch=4, seq=32, ckpt_every=4, fail_step=5)


def _counted_flash(q, k, v):
    count_launch(flash_ops.flash_attention, "fma")
    return flash_ops.flash_attention_ref(q, k, v)


def _counted_product(x, w):
    count_launch(gmm_ops.gmm, "f32")
    return gmm_ops.gmm_ref(x, w)


@pytest.fixture
def patched():
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(attention_mod, "flash_attention", _counted_flash)
        mp.setattr(gmm_ops, "_product", _counted_product)
        yield mp, lines


def test_gmm_backward_part_runs_on_cpu(patched):
    _, lines = patched
    out = chip_smoke.phase_gmm_backward(torch, device="cpu", cases=TOY_GMM,
                                        timed=False)
    assert out["rel"] <= chip_smoke.GMM_NORM_TOL["bfloat16"]
    assert out["worst"] <= 1.0
    assert sum("[train] gmm backward" in ln for ln in lines) == 2


def test_gmm_backward_gate_catches_a_wrong_gradient(patched):
    mp, _ = patched
    good = gmm_ops.GroupedMatmul.backward

    def bad(ctx, dy):
        dx, dw = good(ctx, dy)
        return dx, dw * 1.1
    mp.setattr(gmm_ops.GroupedMatmul, "backward", staticmethod(bad))
    with pytest.raises(RuntimeError, match="dW .* disagrees"):
        chip_smoke.phase_gmm_backward(torch, device="cpu", cases=TOY_GMM,
                                      timed=False)


def test_train_phase_runs_on_cpu(patched, tmp_path):
    _, lines = patched
    out = chip_smoke.phase_train(torch, device="cpu", reduced=True,
                                 run=TOY_RUN, ckpt_root=tmp_path / "ck",
                                 min_fall=0.02)
    text = "\n".join(lines)
    assert "[train] [loop] restored step 4" in text
    assert "injected node failure at step 5" in text
    assert out["replay"] == 0.0 and out["n_equal"] == TOY_RUN["steps"]
    assert out["eval_launches"] == 3 and out["eval_rel"] <= 1e-6
    assert out["eval_flash_err"] == 0.0
    assert out["tokens_per_s"] > 0 and out["peak_gb"] == 0.0
    assert out["window_s"] < out["clean_s"] and out["run_tokens_per_s"] > 0
    assert not (tmp_path / "ck").exists()          # checkpoints removed
    assert "[train] eval step (no_grad): 3 flash launches" in text


def test_train_phase_gates_on_the_restore(patched, tmp_path):
    """A failed run that starts over instead of restoring fails the gate,
    even though its losses replay."""
    mp, _ = patched
    from repro_torch.checkpoint import Checkpointer
    mp.setattr(Checkpointer, "latest_step", lambda self: None)
    with pytest.raises(RuntimeError, match="did not restore step 4"):
        chip_smoke.phase_train(torch, device="cpu", reduced=True,
                               run=TOY_RUN, ckpt_root=tmp_path / "ck",
                               min_fall=0.02)


def test_train_phase_gates_each_eval_flash_launch(patched, tmp_path):
    """A flash launch that leaves the causal mask off moves the eval loss
    little; the check of each launch on its own inputs catches it."""
    mp, _ = patched

    def unmasked(q, k, v):
        count_launch(flash_ops.flash_attention, "fma")
        rep = q.shape[2] // k.shape[2]
        kk, vv = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / q.shape[-1] ** 0.5
        return torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), vv)
    mp.setattr(attention_mod, "flash_attention", unmasked)
    with pytest.raises(RuntimeError, match="flash launch 0 .* disagrees"):
        chip_smoke.phase_train(torch, device="cpu", reduced=True,
                               run=TOY_RUN, ckpt_root=tmp_path / "ck",
                               min_fall=0.02)


def test_moe_train_phase_runs_on_cpu(patched):
    _, lines = patched
    out = chip_smoke.phase_moe_train(torch, device="cpu")
    # 3 sites x 3 layers x (forward + recompute + 2 backward) x 2
    # microbatches x 3 steps
    assert out["launches"] == 3 * 3 * 4 * 2 * 3
    assert out["rel"] == {"loss": 0.0, "grad_norm": 0.0}
    assert out["grad_err"] == 0.0
    assert any("every expert grad finite and nonzero" in ln for ln in lines)


def test_moe_train_phase_gates_on_the_launch_count(patched):
    """A backward that did not run through the kernel (no launch counted
    while autograd runs it) fails the count."""
    mp, _ = patched

    def forward_only(x, w):
        if torch.is_grad_enabled():
            count_launch(gmm_ops.gmm, "f32")
        return gmm_ops.gmm_ref(x, w)
    mp.setattr(gmm_ops, "_product", forward_only)
    with pytest.raises(RuntimeError, match="moe_gmm launched"):
        chip_smoke.phase_moe_train(torch, device="cpu")


def test_moe_train_phase_gates_on_the_expert_grads(patched):
    """A backward that is wrong only in the run held against the CPU's
    (the first step's 3 sites x 3 layers x 2 microbatches) fails the
    elementwise gate on the expert grads."""
    mp, _ = patched
    good = gmm_ops.GroupedMatmul.backward
    calls = []

    def first_step_wrong(ctx, dy):
        calls.append(1)
        dx, dw = good(ctx, dy)
        return (dx, dw * 1.01) if 18 < len(calls) <= 36 else (dx, dw)
    mp.setattr(gmm_ops.GroupedMatmul, "backward",
               staticmethod(first_step_wrong))
    with pytest.raises(RuntimeError, match="expert grads on the card vs "
                                           "the CPU differ"):
        chip_smoke.phase_moe_train(torch, device="cpu")
