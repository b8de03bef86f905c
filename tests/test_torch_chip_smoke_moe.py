"""chip_smoke.py's grouped-matmul phase 3e and its MoE phase 12, rehearsed
on the CPU at toy size.

As in tests/test_torch_chip_smoke_hybrid.py: the script refuses to run
without a card, so its phases take a device and the reduced config, and
their control flow (kernel vs plain at the path's own inputs, bounds, the
launch gates, drop accounting, paged tokens equal to dense tokens, the
logits gate with routing flips, the ``kernels`` entry) is exercised here
first.  Timings are stubbed: CUDA events exist only on the card; the CPU
path launches nothing, so each wrapper's calls are counted as launches.
"""
import dataclasses
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import repro_torch.kernels.moe_gmm as gmm_pkg  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (a fixture)


def _counted(op, ref):
    """Count a CPU call of ``op`` as a launch of its kernel."""
    def call(*args):
        op.launches += 1
        return ref(*args)
    return call


@pytest.fixture
def kernels_patched():
    """CUDA timing stubbed; the phases log into the returned list."""
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
        mp.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
        yield lines


@pytest.fixture
def moe_patched(kernels_patched):
    """Phase 12 on the CPU: every kernel wrapper on its path counted."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("decode_attention", "paged_decode_attention"):
            mp.setattr(attention, name, _counted(getattr(ops, name),
                                                 getattr(ops, f"{name}_ref")))
        mp.setattr(attention, "flash_attention",
                   _counted(flash_ops.flash_attention,
                            flash_ops.flash_attention_ref))
        mp.setattr(moe, "gmm", _counted(gmm_ops.gmm, gmm_ops.gmm_ref))
        yield kernels_patched


def test_gmm_kernel_phase_runs_on_cpu(kernels_patched):
    """Phase 3e at small shapes: a timed case and a ragged edge case."""
    chip_smoke.phase_gmm_kernels(torch, device="cpu", cases=[(2, 8, 64, 48)],
                                 edge_cases=[(3, 1, 100, 72)])
    assert len(kernels_patched) == 4
    assert all("max_abs_err=0, 0 of the tolerance" in line
               for line in kernels_patched)
    assert sum("bmm_ms=" in line for line in kernels_patched) == 2


def test_gmm_bound_counts_bytes_and_flops():
    """dbrx-132b's decode and cap-224 prefill gate/up calls are both held
    by the 2.11 GB weight read, not by the bf16 flops."""
    for cap in (8, 224):
        x = torch.empty(16, cap, 6144, dtype=torch.bfloat16)
        w = torch.empty(16, 6144, 10752, dtype=torch.bfloat16)
        ms, by = chip_smoke.gmm_bound_ms(x, w)
        nbytes = 2 * (x.numel() + w.numel() + 16 * cap * 10752)
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
        flops_ms = (2 * 16 * cap * 6144 * 10752
                    / chip_smoke.PEAK_FLOPS["bfloat16"] * 1e3)
        assert flops_ms < ms
    assert 0.66 < ms < 0.67 and 0.47 < flops_ms < 0.49   # cap 224


def test_gmm_gate_refuses_a_wrong_kernel(kernels_patched):
    """A kernel one ulp-sized error off passes; one that drops a row of
    the contraction fails the normwise gate."""
    gen = torch.Generator().manual_seed(0)
    x, w = chip_smoke.gmm_inputs(torch, 2, 8, 64, 48, torch.float32, "cpu",
                                 gen)
    assert chip_smoke.gmm_case_ms(torch, [(x, w)], timed=False)["err"] == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gmm_pkg, "gmm",
                   lambda x_, w_: gmm_ops.gmm_ref(x_[:, :, 1:].contiguous(),
                                                  w_[:, 1:].contiguous()))
        with pytest.raises(RuntimeError, match="kernel disagrees"):
            chip_smoke.gmm_case_ms(torch, [(x, w)], timed=False)


def test_routing_flips_count_changed_choices():
    a = [torch.tensor([[0, 1], [2, 3], [4, 5]])]
    b = [torch.tensor([[1, 0], [2, 6], [7, 8]])]
    rows = torch.tensor([True, True, False])
    flips, flipped = chip_smoke.routing_flips(torch, a, b, rows)
    assert flips == 1 and flipped.tolist() == [False, True]


def _reduced(capacity_factor=None):
    from repro_torch.configs import reduced_config
    cfg = reduced_config("dbrx-132b")
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(0, device="cpu")


def test_drop_accounting_counts_pairs_dropped_at_capacity():
    """At capacity 0.5 prefill calls drop pairs, attributed to the
    requests they held; decode at 8 slots cannot drop (cap 8); the
    wrapped run's tokens equal a plain run's."""
    cfg, bundle, params = _reduced(capacity_factor=0.5)
    engine = ServeEngine(bundle, params, EngineConfig(
        slots=8, cache_len=64, pad_to=8, max_prefill_batch=8), device="cpu")
    reqs = chip_smoke.burst_requests(cfg, 4, (4, 40))
    drops, decode, tokens = chip_smoke.drop_accounting(
        torch, engine, reqs, "prefill_slotted")
    assert set(drops) == set(range(16)) and sum(drops.values()) > 0
    assert decode == 0
    plain = engine.run(chip_smoke.burst_requests(cfg, 4, (4, 40)))
    assert tokens == {r.rid: r.out for r in plain}


def test_moe_phase_runs_on_cpu(moe_patched):
    """Phase 12 on reduced dbrx-132b (3 layers): the launch gates of both
    engines, paged tokens = dense tokens, the logits gate, the kernel at
    one prefill's and one decode step's inputs, and the kernels entry."""
    out = chip_smoke.phase_moe(torch, device="cpu", reduced=True,
                               cache_len=64, lengths=(4, 40))
    text = "\n".join(moe_patched)
    dense, paged = out["dense"], out["paged"]
    assert dense["tokens"] == paged["tokens"]
    for run, decode in ((dense, "decode_attention"),
                        (paged, "paged_decode_attention")):
        s = run["stats"]
        assert run["counts"]["moe_gmm"] == \
            9 * (s["prefill_calls"] + s["decode_steps"])
        assert run["counts"]["flash_attention"] == 3 * s["prefill_calls"]
        assert run["counts"][decode] == 3 * s["decode_steps"]
        assert run["step_rel"] == 0.0 and run["flips"] == 0
        assert run["decode_drops"] == 0
    assert "tokens equal to the dense engine's for 16/16 requests" in text
    assert text.count("tokens equal to the first run's for 16/16") == 2
    for which in ("prefill", "decode"):
        assert out["paths"][which]["err"] == 0.0
        assert out["paths"][which]["bound_by"] in ("bytes", "operations")
    assert len(re.findall(r"\[kernel\] moe_gmm at one", text)) == 2
    entry = chip_smoke.gmm_entry(out)
    assert entry["launches"] == dense["counts"]["moe_gmm"] > 0
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= \
        set(entry)
    assert (Path(chip_smoke.ROOT) / entry["source"]).exists()


def test_moe_phase_gates_on_gmm_launches(moe_patched):
    """Expert FFNs that skip the kernel fail the launch gate."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "gmm", gmm_ops.gmm_ref)
        with pytest.raises(RuntimeError, match="moe_gmm launched 0 times"):
            chip_smoke.phase_moe(torch, device="cpu", reduced=True,
                                 cache_len=64, lengths=(4, 40))
