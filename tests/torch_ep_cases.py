"""The cases of tests/test_torch_moe_ep.py, in numpy alone: read by the
JAX side (tests/torch_ep_reference.py, ``repro``'s ``moe_block`` on 4
forced host devices) and by the port's side (tests/torch_ep_ranks.py, 4
gloo ranks), which draw the same inputs from the same seeds.

The config is tests/ep_equivalence_check.py's tiny-moe (8 experts, top-2,
one shared expert, d_model 32); each case names its mesh, its changes to
that config, its input's shape and seed, and whether gradients are taken.
"""
import numpy as np

AXES = ("data", "model")
TINY_MOE = dict(
    name="tiny-moe", family="moe", n_layers=1, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab_size=128, n_experts=8, experts_per_token=2,
    moe_d_ff=48, n_shared_experts=1, capacity_factor=8.0, dtype="float32",
    moe_impl="ep_a2a")

# name: (mesh shape, config changes, x shape, x seed, grads)
CASES = {
    # the EP path against the reference's, where no pair drops and where
    # EP and the sort path drop other pairs (capacity 1.0)
    "2x2_cf8": ((2, 2), {}, (4, 16, 32), 1, True),
    "2x2_cf1": ((2, 2), dict(capacity_factor=1.0), (4, 16, 32), 1, True),
    "1x4_cf8": ((1, 4), {}, (4, 16, 32), 1, True),
    "1x4_cf1": ((1, 4), dict(capacity_factor=1.0), (4, 16, 32), 1, True),
    "2x2_cf1_unshared": ((2, 2), dict(capacity_factor=1.0,
                                      n_shared_experts=0), (4, 16, 32), 1,
                         True),
    "1x4_cf1_unshared": ((1, 4), dict(capacity_factor=1.0,
                                      n_shared_experts=0), (4, 16, 32), 1,
                         True),
    # a decode step (S 1 does not divide the 4 ranks of "model"): the sort
    # path, in both packages
    "1x4_s1": ((1, 4), dict(capacity_factor=1.0), (8, 1, 32), 2, False),
    # capacity 0.2: c_send 8 and c_loc 0, every routed pair drops
    "2x2_cloc0": ((2, 2), dict(capacity_factor=0.2), (4, 16, 32), 1,
                  False),
    # capacity 1.0 on (1, 4): empty slots of a source rank sort as local
    # expert 0 and push a later source's expert-0 rows past c_loc
    "1x4_empty": ((1, 4), dict(capacity_factor=1.0), (4, 16, 32), 3,
                  False),
}
PARAM_SEED = 0


def params(cfg: dict, seed: int = PARAM_SEED) -> dict:
    """The MoE block's params (fan-in scaled normals), f32 numpy."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg["d_model"], cfg["moe_d_ff"], cfg["n_experts"]

    def draw(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    p = {"router": draw((d, e), d), "gate": draw((e, d, f), d),
         "up": draw((e, d, f), d), "down": draw((e, f, d), f)}
    fs = f * TINY_MOE["n_shared_experts"]
    shared = {"shared_gate": draw((d, fs), d), "shared_up": draw((d, fs), d),
              "shared_down": draw((fs, d), fs)}
    if cfg["n_shared_experts"]:
        p.update(shared)
    return p


def case_inputs(name: str):
    """(config dict, params, x) of a case, numpy."""
    _, change, shape, seed, _ = CASES[name]
    cfg = dict(TINY_MOE, **change)
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return cfg, params(cfg), x
