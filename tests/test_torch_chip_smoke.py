"""chip_smoke.py's serving phase, rehearsed on the CPU at toy size.

The script itself refuses to run without a card; its serve phase takes a
device and the reduced config so that its control flow (requests, launch
accounting, the kernel-vs-plain logits check, the oracle share) is
exercised here before any chip time is spent.  Timings are stubbed: CUDA
events exist only on the card.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402


def test_serve_phase_runs_on_cpu(monkeypatch, capsys):
    def counted(q, k, v, kv_len):      # the CPU path launches nothing
        ops.decode_attention.launches += 1
        return ops.decode_attention_ref(q, k, v, kv_len)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
    monkeypatch.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
    monkeypatch.setattr(attention, "decode_attention", counted)
    monkeypatch.setattr(ops.decode_attention, "launches", 0)
    launches, path = chip_smoke.phase_serve(torch, device="cpu",
                                            reduced=True)
    out = capsys.readouterr().out
    assert "16 requests" in out and "rel_err=0 " in out
    assert launches > 0 and launches % 3 == 0        # steps x 3 layers
    assert path["bound_by"] == "bytes" and path["err"] == 0.0
    assert len(path["kv_len"]) == 8
