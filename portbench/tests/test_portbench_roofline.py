"""The frozen formulas reproduce PERF.md's bound column (section 6, the
port's kernel table) at its shapes."""
from __future__ import annotations

import pytest

from portbench.roofline import decode_attention, flash, gmm, peaks, step


def ms(flops_bytes) -> float:
    return 1e3 * peaks.least_s(*flops_bytes)


def test_decode_attention_mistral_96_over_8():
    # phase 3: B 8, cache 1024, these lengths, dense kernel (no tables)
    lens = [1, 1024, 37, 129, 400, 700, 1000, 255]
    got = ms(decode_attention.flops_bytes(8, 96, 8, 128, lens,
                                          block_size=None))
    assert round(got, 4) == 0.0045


@pytest.mark.parametrize("h,kvh,want", [(48, 1, 0.0061), (96, 8, 0.0122)])
def test_flash_at_700_tokens(h, kvh, want):
    assert round(ms(flash.flops_bytes(1, 700, h, kvh, 128)), 4) == want


@pytest.mark.parametrize("c,want", [(8, 0.6323), (224, 0.6672)])
def test_gmm_at_dbrx_widths(c, want):
    assert round(ms(gmm.flops_bytes(16, c, 6144, 10752)), 4) == want


def test_capacity_rule():
    assert gmm.capacity(64, 4, 16, 1.25) == 24
    assert gmm.capacity(1, 4, 16, 1.25) == 8
    assert gmm.capacity(704, 4, 16, 1.25) == 224


def test_a_decode_step_reads_the_weights_once():
    dbrx = {"family": "moe", "n_layers": 8, "d_model": 6144, "n_heads": 48,
            "n_kv_heads": 8, "head_dim": 128, "vocab_size": 100352,
            "n_experts": 16, "experts_per_token": 4, "moe_d_ff": 10752}
    flops, nbytes = step.decode_flops_bytes(dbrx, [1] * 64)
    # 27.3 B params in bf16 (54.6 GB), less the embedding table (1.23
    # GB) but its 64 rows
    assert 53.3e9 < nbytes < 53.5e9
    assert 1e3 * peaks.least_s(flops, nbytes) == pytest.approx(15.94, 0.01)
    # below 4 E pairs a step counts the fewest experts any step reaches,
    # k = 4 of the 16, whatever its rows: a floor on the bytes
    few = [step.decode_flops_bytes(dbrx, [1] * b)[1] for b in (1, 2, 8)]
    assert few[0] < few[1] < few[2] < 0.32 * nbytes
    assert few[2] - few[0] < 1e8
