"""``repro``'s ``moe_block`` on the cases of tests/torch_ep_cases.py, on 4
forced host devices; run by tests/test_torch_moe_ep.py:

  PYTHONPATH=src python tests/torch_ep_reference.py OUT.npz

Each case runs under ``axis_rules`` on its (data, model) mesh, so a case
whose sequence divides "model" takes ``moe_block_ep`` and the others the
sort path.  Writes ``<case>/y``, ``<case>/aux`` and, where the case takes
gradients, ``<case>/grad/<param>`` of ``sum(y ** 2) + aux``; where
``moe_block_ep`` does not trace (capacity ``c_loc`` 0), ``<case>/raised``.
The meshes have Auto axes: on jax 0.9's default Explicit axes the shared
expert's reshape under explicit sharding raises in the gradient
(tests/ep_equivalence_check.py).
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ep_cases import AXES, CASES, case_inputs  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.distributed.sharding import axis_rules, default_rules  # noqa: E402
from repro.models.moe import moe_block  # noqa: E402


def run(name: str, out: dict) -> None:
    shape, _, _, _, grads = CASES[name]
    cfg_d, p, x = case_inputs(name)
    cfg = ModelConfig(**cfg_d)
    mesh = jax.make_mesh(shape, AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    p = {k: jnp.asarray(v) for k, v in p.items()}
    x = jnp.asarray(x)

    def loss(p_):
        y, aux = moe_block(p_, x, cfg)
        return jnp.sum(y ** 2) + aux

    with axis_rules(default_rules(multi_pod=False), mesh):
        try:
            y, aux = jax.jit(lambda p_, x_: moe_block(p_, x_, cfg))(p, x)
        except TypeError as e:
            if "gather" not in str(e):
                raise
            # c_loc 0: the combine's gather from the empty (E_loc, 0, D)
            # buffer does not trace
            out[f"{name}/raised"] = np.asarray(1)
            return
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/aux"] = np.asarray(aux)
        if grads:
            for k, g in jax.jit(jax.grad(loss))(p).items():
                out[f"{name}/grad/{k}"] = np.asarray(g)


if __name__ == "__main__":
    result: dict = {}
    for case in CASES:
        run(case, result)
    np.savez(sys.argv[1], **result)
