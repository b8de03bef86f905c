"""chip_smoke.py's phase 13 (HALF's search, serve_winner and the batched
trainer), rehearsed on the CPU at toy size.

The script refuses to run without a card, so the phase takes a device and
NASConfig overrides; its control flow and every gate (the dormant-gene
cache, the conv launch count, batched = scalar, kernel = plain on the eval
logits, the served records) run here first.  The CPU path launches no
kernel, so each conv wrapper call is counted as its launch, through the
same locked counter the wrappers use (the search trains on two threads).
Timings are stubbed: CUDA events exist only on the card.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import repro_torch.hwlib.layers as layers_mod  # noqa: E402
from repro_torch.core import trainer  # noqa: E402
from repro_torch.core import trainer_batch  # noqa: E402
from repro_torch.core.genome import Genome  # noqa: E402
from repro_torch.data.ecg import (  # noqa: E402
    make_ecg_dataset,
    train_val_split,
)
from repro_torch.kernels._launches import count_launch  # noqa: E402
from repro_torch.kernels.conv1d import ops as conv_ops  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (a fixture)

# toy size: 3 initial candidates and 2 generations of 4 children, 2
# accepted, 2 steps at batch 4 (the buckets too); the acceptance limits
# are lifted, since two steps train nothing and serve_winner needs a
# feasible candidate
TOY = dict(generations=2, children_per_gen=4, n_accept=2, init_population=3,
           train_steps=2, train_batch=4, det_min=0.0, fa_max=1.0)


@pytest.fixture(scope="module")
def data():
    x, y = make_ecg_dataset(seed=0, n_samples=24, decimation=16)
    return train_val_split(x, y)


def _counted(*args, **kw):
    count_launch(conv_ops.dwsep_conv1d)
    return conv_ops.dwsep_conv1d_ref(*args, **kw)


@pytest.fixture
def patched():
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(layers_mod, "dwsep_conv1d", _counted)
        mp.setattr(conv_ops.dwsep_conv1d, "launches", 0)
        yield mp, lines


def _run(data, **kw):
    return chip_smoke.phase_search(torch, data, device="cpu", serve_steps=2,
                                   serve_batch=4, bucket_steps=2,
                                   profile_steps=1, **{**TOY, **kw})


def test_search_phase_runs_on_cpu(data, patched):
    _, lines = patched
    out = _run(data)
    text = "\n".join(lines)
    state = out["state"]
    assert state.generation == 2 and len(state.history) == 2
    assert out["rates"]["candidates"] == len(state.evaluated_hashes) >= 3
    assert out["launches"] > 0
    assert out["logit_err"] <= chip_smoke.ECG_LOGIT_TOL
    for key in ("search_s", "host_s", "train_s", "candidates_per_s",
                "served_records_per_s", "batched_steps_per_s",
                "scalar_steps_per_s", "bucket_step_ms", "eval_ms"):
        assert out["rates"][key] > 0, key
    assert "cut from the paper's run: 2 of 100 generations" in text
    assert "behind 2 replicas" in text
    assert "[search] winner (low_energy)" in text
    assert "the winner's phenotype at 4 quant settings (w8a16i16, " \
        "w4a16i16, w8a8i16, w8a16i8), 2 steps each (reported" in text
    assert "one bucket of phase 9's phenotype at 4 quant settings, 2 " \
        "steps each" in text


def _fail_first_call(mp):
    real = trainer_batch.train_candidates_batched
    seen = []

    def flaky(*args, **kw):
        seen.append(1)
        if len(seen) == 1:
            raise RuntimeError("injected bucket failure")
        return real(*args, **kw)
    mp.setattr(trainer_batch, "train_candidates_batched", flaky)


def _wrong_scalar(mp):
    real = trainer.train_candidate

    def wrong(*args, **kw):
        r = real(*args, **kw)
        r.detection_rate = 1.0 - r.detection_rate
        return r
    mp.setattr(trainer, "train_candidate", wrong)


def _noisy_kernel(mp):
    def noisy(*args, **kw):
        out = _counted(*args, **kw)
        return out + 1e-2 * out.abs().max()
    mp.setattr(layers_mod, "dwsep_conv1d", noisy)


def _skip_kernel(mp):
    mp.setattr(layers_mod, "dwsep_conv1d", conv_ops.dwsep_conv1d_ref)


@pytest.mark.parametrize("breakage,match", [
    (_skip_kernel, "dwsep_conv1d launched 0 times"),
    (_fail_first_call, "trained twice"),
    (_wrong_scalar, "batched .* differs from scalar"),
    (_noisy_kernel, "eval logits, kernel vs plain conv"),
], ids=["conv_skips_the_kernel", "a_bucket_retried", "scalar_differs",
        "kernel_differs_from_plain"])
def test_a_broken_gate_raises(data, patched, breakage, match):
    mp, _ = patched
    breakage(mp)
    with pytest.raises(RuntimeError, match=match):
        _run(data)


def test_search_conv_launches_counts_bn_and_forwards():
    """Phase 9's genome has six convs: BN re-estimation takes two launches
    a conv, each no-grad forward one."""
    specs = Genome(**chip_smoke.ECG_GENES).phenotype()
    assert chip_smoke.search_conv_launches(specs, 1) == 6 * 3
    assert chip_smoke.search_conv_launches(specs, 0) == 12
    assert chip_smoke.search_conv_launches(specs[4:5], 3) == 0  # the pool
