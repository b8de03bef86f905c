"""chip_smoke.py's phase 14 (training), rehearsed on the CPU at toy size.

The script refuses to run without a card, so each part takes a device
(and phase 14b its run's size); the control flow and every gate (the
gmm backward against autograd through gmm_ref and against itself bit for
bit, the launcher's clean and failed runs, bit for bit, the eval step's
flash launches, the MoE launch count and the card-vs-CPU step) run here
first.  The CPU path launches no kernel, so
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


def _counted_flash(q, k, v, causal=True):
    count_launch(flash_ops.flash_attention, "fma")
    return flash_ops.flash_attention_ref(q, k, v, causal)


def _counted_product(x, w):
    count_launch(gmm_ops.gmm, "f32")
    return gmm_ops.gmm_ref(x, w)


def _counted_grad(which, x, w, dy):
    if which == gmm_ops._DX:
        count_launch(gmm_ops.gmm, "dx_f32")
        return gmm_ops.gmm_dx_ref(dy, w)
    count_launch(gmm_ops.gmm, "dw_f32")
    return gmm_ops.gmm_dw_ref(x, dy)


@pytest.fixture
def patched():
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(attention_mod, "flash_attention", _counted_flash)
        mp.setattr(gmm_ops, "_product", _counted_product)
        mp.setattr(gmm_ops, "_grad", _counted_grad)
        yield mp, lines


def test_gmm_backward_part_runs_on_cpu(patched):
    _, lines = patched
    out = chip_smoke.phase_gmm_backward(torch, device="cpu", cases=TOY_GMM,
                                        timed=False)
    assert [r["case"] for r in out] == TOY_GMM
    for r, (*_, name) in zip(out, TOY_GMM):
        assert r["rel"] <= chip_smoke.GMM_NORM_TOL[name]
        assert r["worst"] <= 1.0 and r["repeats"]
    assert out[0]["paths"] == ("dx_wgmma", "dw_wgmma")
    assert out[1]["paths"] == ("dx_f32", "dw_f32")
    assert sum("[train] gmm backward" in ln and "equal bit for bit" in ln
               for ln in lines) == 2


def test_gmm_backward_gate_catches_a_backward_that_does_not_repeat(patched):
    """A backward whose second call differs in one element by one ulp
    (as a sum in a run-dependent order would) fails the repeat gate,
    though both calls are within the tolerance of autograd."""
    mp, _ = patched
    good = gmm_ops.GroupedMatmul.backward
    calls = []

    def drifting(ctx, dy):
        dx, dw = good(ctx, dy)
        calls.append(1)
        if len(calls) == 2:
            dw = dw.clone()
            dw.view(-1)[0] = torch.nextafter(dw.view(-1)[0],
                                             torch.tensor(float("inf"),
                                                          dtype=dw.dtype))
        return dx, dw
    mp.setattr(gmm_ops.GroupedMatmul, "backward", staticmethod(drifting))
    with pytest.raises(RuntimeError, match="two backward calls .* differ"):
        chip_smoke.phase_gmm_backward(torch, device="cpu", cases=TOY_GMM,
                                      timed=False)


def test_gmm_grad_bound_counts_each_product():
    """dX reads dY and W and writes dX, dW reads X and dY and writes dW;
    together the two, each 2 E C D F flops; bf16 at dbrx-132b's prefill
    shape is bound by bytes (1.3344 ms, PERF.md)."""
    x = torch.empty(16, 224, 6144, dtype=torch.bfloat16, device="meta")
    w = torch.empty(16, 6144, 10752, dtype=torch.bfloat16, device="meta")
    both, by = chip_smoke.gmm_grad_bound_ms(x, w)
    dx, _ = chip_smoke.gmm_grad_bound_ms(x, w, ("dx",))
    dw, _ = chip_smoke.gmm_grad_bound_ms(x, w, ("dw",))
    assert by == "bytes" and abs(both - 1.3344) < 1e-3
    assert abs(dx + dw - both) < 1e-9 and abs(dx - dw) < 1e-9


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
    assert out["params_equal"] and out["n_leaves"] > 0
    assert "final params equal bit for bit" in text
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


def test_train_phase_gates_a_replay_off_by_an_ulp(patched, tmp_path):
    """A restore that moves one param leaf by one ulp replays well within
    the 2e-3 tolerance but not bit for bit: the bitwise gate fails it."""
    mp, _ = patched
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim.adamw import tree_leaves
    good = Checkpointer.restore

    def nudged(self, like, step=None):
        start, state = good(self, like, step)
        leaf = tree_leaves(state.params)[-1]
        leaf.copy_(torch.nextafter(leaf, torch.full_like(leaf, 1e30)))
        return start, state
    mp.setattr(Checkpointer, "restore", nudged)
    with pytest.raises(RuntimeError, match="not the clean run bit for bit"):
        chip_smoke.phase_train(torch, device="cpu", reduced=True,
                               run=TOY_RUN, ckpt_root=tmp_path / "ck",
                               min_fall=0.02)


def test_train_phase_gates_each_eval_flash_launch(patched, tmp_path):
    """A flash launch that leaves the causal mask off moves the eval loss
    little; the check of each launch on its own inputs catches it."""
    mp, _ = patched

    def unmasked(q, k, v, causal=True):
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
    """A backward that did not run through the kernel (its products left
    to the plain versions, no launch counted) fails the count."""
    mp, _ = patched

    def plain_grad(which, x, w, dy):
        return gmm_ops.gmm_dx_ref(dy, w) if which == gmm_ops._DX \
            else gmm_ops.gmm_dw_ref(x, dy)
    mp.setattr(gmm_ops, "_grad", plain_grad)
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
