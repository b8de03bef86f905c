"""The port's fault-tolerant training loop (CPU, reduced configs): injected
failures restore and replay to the uninterrupted run bit for bit, the
port resumes the reference's own checkpoint and continues the reference's
run, and the launcher trains."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data.lm import LMDataConfig as JaxLMDataConfig
from repro.data.lm import data_iterator as jax_data_iterator
from repro.models.registry import build_model as jax_build_model
from repro.training.loop import LoopConfig as JaxLoopConfig
from repro.training.loop import train_loop as jax_train_loop
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.data.lm import LMDataConfig, data_iterator, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.training.loop import LoopConfig, batch_to_device, train_loop
from repro_torch.training.step import make_train_step
from repro_torch.weights import train_state_from_jax
from torch_parity import one_thread  # noqa: F401 (a fixture)


def _fail_once_at(steps):
    fired = set()

    def inject(step):
        if step in steps and step not in fired:
            fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")
    return inject


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b"])
def test_injected_failures_replay_bit_for_bit(tmp_path, arch):
    """Two failures (steps 5 and 9, checkpoints every 4): the loop restores
    steps 4 and 8, replays, and every step's loss and the final params
    equal the uninterrupted run's exactly."""
    cfg = reduced_config(arch)
    bundle = build_model(cfg)
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4)
    lines = []

    def run(d, injector=None):
        return train_loop(bundle, lambda s: data_iterator(data_cfg, s),
                          LoopConfig(total_steps=12, ckpt_every=4,
                                     ckpt_dir=str(d), log_every=1,
                                     max_restarts=3),
                          device="cpu", fail_injector=injector,
                          log=lines.append)

    clean = run(tmp_path / "clean")
    faulty = run(tmp_path / "faulty", _fail_once_at({5, 9}))
    assert clean["restarts"] == 0 and faulty["restarts"] == 2
    assert [ln for ln in lines if "restored" in ln] == [
        "[loop] restored step 4", "[loop] restored step 8"]
    assert faulty["loss_at"] == clean["loss_at"]
    assert len(faulty["losses"]) == 12 + 1 + 1   # steps 4 and 8 replayed
    for a, b in zip(tree_leaves(clean["state"].params),
                    tree_leaves(faulty["state"].params)):
        assert torch.equal(a, b)
    assert clean["loss_at"][11] < clean["loss_at"][0]


def test_restarts_are_bounded(tmp_path):
    cfg = reduced_config("qwen2-0.5b")
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=2)

    def always(step):
        raise RuntimeError("node lost")

    with pytest.raises(RuntimeError, match="node lost"):
        train_loop(build_model(cfg), lambda s: data_iterator(data_cfg, s),
                   LoopConfig(total_steps=4, ckpt_dir=str(tmp_path),
                              max_restarts=2),
                   device="cpu", fail_injector=always, log=lambda m: None)


def test_port_resumes_the_reference_checkpoint(tmp_path):
    """The reference trains 2 steps and checkpoints; the port restores that
    checkpoint (its stacked layers and AdamW state) and runs steps 3-4,
    which match the reference's own steps 3-4 to 1e-4 relative."""
    jcfg = jax_reduced_config("qwen2-0.5b")
    jdata = JaxLMDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                            global_batch=4)
    jbundle = jax_build_model(jcfg)

    def jrun(total):
        return jax_train_loop(
            jbundle, lambda s: jax_data_iterator(jdata, s),
            JaxLoopConfig(total_steps=total, ckpt_every=2,
                          ckpt_dir=str(tmp_path), log_every=1),
            rng=jax.random.PRNGKey(0), log=lambda m: None)

    jrun(2)
    step, tree = Checkpointer(str(tmp_path)).restore_tree(2)
    state = train_state_from_jax(tree, "cpu")
    want = jrun(4)["losses"]                 # restores step 2, runs 2 and 3
    assert step == 2 and state.step == 2 and len(want) == 2
    cfg = reduced_config("qwen2-0.5b")
    train_step, _ = make_train_step(build_model(cfg))
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4)
    got = []
    for s in (2, 3):
        state, met = train_step(state, batch_to_device(
            make_batch(data_cfg, s), torch.device("cpu")))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                             "cpu", "--steps", "6", "--batch", "4", "--seq",
                             "32", "--ckpt-dir", str(tmp_path),
                             "--ckpt-every", "3", "--log-every", "1"])
    text = capsys.readouterr().out
    assert "arch=qwen2-0.5b-smoke" in text and "device=cpu" in text
    assert "done: losses" in text and "restarts=0" in text
    assert len(out["losses"]) == 6 and out["state"].step == 6
    assert Checkpointer(str(tmp_path)).all_steps() == [3, 6]


def test_launcher_defaults_to_the_card_and_full_width():
    """Without --device the launcher wants the card (no silent CPU run);
    without --reduced it builds the published config."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
