"""The port's copy of the synthetic LM token stream equals the reference's
bit for bit, restarts at any step included."""
import numpy as np
import pytest

from repro.data.lm import LMDataConfig as JaxLMDataConfig
from repro.data.lm import data_iterator as jax_data_iterator
from repro.data.lm import make_batch as jax_make_batch
from repro_torch.data.lm import LMDataConfig, data_iterator, make_batch

CASES = [dict(vocab_size=97, seq_len=16, global_batch=4),
         dict(vocab_size=151936, seq_len=64, global_batch=8, seed=3),
         dict(vocab_size=512, seq_len=32, global_batch=6, host_index=1,
              host_count=3)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_make_batch_equals_reference(case):
    cfg, jcfg = LMDataConfig(**CASES[case]), JaxLMDataConfig(**CASES[case])
    for step in (0, 1, 12):
        got, want = make_batch(cfg, step), jax_make_batch(jcfg, step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_restart_at_step_n_equals_reference():
    cfg, jcfg = LMDataConfig(**CASES[0]), JaxLMDataConfig(**CASES[0])
    it, jit = data_iterator(cfg, start_step=12), \
        jax_data_iterator(jcfg, start_step=12)
    for _ in range(3):
        a, b = next(it), next(jit)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(next(data_iterator(cfg, 12))["labels"],
                                  make_batch(cfg, 12)["labels"])
