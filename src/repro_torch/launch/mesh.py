"""Meshes and per-arch sharding-rule overrides, and the accelerators a
search may spread its training over.

Counterpart of ``repro/launch/mesh.py``.  A mesh is a ``torch.distributed``
``DeviceMesh`` over the process group's world, its dims named as the
reference's mesh axes: ``("data", "model")`` at (16, 16), or ``("pod",
"data", "model")`` at (2, 16, 16).  The mesh builders are FUNCTIONS, so
importing this module touches no process group.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.distributed.sharding import Physical, default_rules


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, whose world size must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh, (16, 16) or (2, 16, 16), over a world of 256
    or 512 ranks."""
    shape = production_mesh_shape(multi_pod)
    return make_mesh(tuple(shape.values()), tuple(shape), device_type)


def local_search_devices(max_devices: Optional[int] = None
                         ) -> List[torch.device]:
    """The CUDA devices of this host, at most ``max_devices`` of them: one
    scheduler worker group per entry (DESIGN.md §11).  Empty without a
    card."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[:max_devices] if max_devices else devs


# Divisibility-driven deviations from the defaults (DESIGN.md §5):
# * whisper-tiny / mamba2-780m: vocab (51865 / 50280) is not divisible by the
#   16-way model axis, so these small tables (<= 160 MB bf16) are
#   replicated (the reference's rule, kept so the two packages shard
#   alike).
ARCH_RULE_OVERRIDES: Dict[str, Dict[str, Physical]] = {
    "whisper-tiny": {"vocab": None, "embed_unsharded": None},
    "mamba2-780m": {"vocab": None, "embed_unsharded": None},
}


def rules_for(arch: str, *, multi_pod: bool, global_batch: int,
              overrides: Optional[Dict[str, Physical]] = None
              ) -> Dict[str, Physical]:
    rules = default_rules(multi_pod)
    rules.update(ARCH_RULE_OVERRIDES.get(arch, {}))
    if global_batch == 1:
        rules["batch"] = None   # degenerate long-context cells
    if overrides:
        rules.update(overrides)
    return rules
