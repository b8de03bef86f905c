"""Static validation in the port: every full-size arch config shards
evenly on both production meshes (``tests/test_config_divisibility.py``'s
three cases, on the port's meta-tensor shapes), and on a deliberately bad
mesh both packages report the same violations."""
import re

import jax
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.distributed.sharding import \
    validate_divisibility as jax_validate_divisibility
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.sharding import validate_divisibility
from repro_torch.launch.mesh import production_mesh_shape, rules_for
from repro_torch.models.registry import build_model

MESHES = {
    "single": production_mesh_shape(multi_pod=False),
    "multi": production_mesh_shape(multi_pod=True),
}
# 7 and 3 divide none of the widths the production mesh's 16 divides
BAD_MESH = {"pod": 3, "data": 7, "model": 7}


def _param_shapes(bundle):
    with FakeTensorMode():
        return bundle.init(0, "cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_param_shardings_divide(arch, mesh_name):
    bundle = build_model(get_config(arch))
    rules = rules_for(arch, multi_pod=mesh_name == "multi",
                      global_batch=256)
    problems = validate_divisibility(_param_shapes(bundle), bundle.specs(),
                                     rules, MESHES[mesh_name])
    assert not problems, problems


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_shardings_divide(arch):
    bundle = build_model(get_config(arch))
    cell = SHAPES["decode_32k"]
    rules = rules_for(arch, multi_pod=False, global_batch=cell.global_batch)
    problems = validate_divisibility(bundle.cache_shapes(cell),
                                     bundle.cache_specs(), rules,
                                     MESHES["single"])
    assert not problems, problems


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_shardings_divide(arch, shape):
    bundle = build_model(get_config(arch))
    cell = SHAPES[shape]
    ok, _ = bundle.supports(cell)
    if not ok:
        pytest.skip("assignment skip rule")
    specs, axes = bundle.input_specs(cell)
    rules = rules_for(arch, multi_pod=True, global_batch=cell.global_batch)
    problems = validate_divisibility(specs, axes, rules, MESHES["multi"])
    assert not problems, problems


_MSG = re.compile(r"^(\S+): dim (\d+) \((\w+)\) size (\d+) not divisible by "
                  r"(\d+) \((.*)\)$")


def _normalised(problems):
    """Each violation as (leaf, logical axis, size, ways, axes): the port's
    list indices and ``repro``'s stacked dims dropped, so a layer's
    violations read alike in both packages."""
    out = set()
    for p in problems:
        name, _, logical, size, total, usable = _MSG.match(p).groups()
        parts = [s for s in name.split(".") if not s.isdigit()]
        out.add((".".join(parts), logical, int(size), int(total), usable))
    return out


@pytest.mark.parametrize("arch", ["qwen3-4b", "dbrx-132b", "zamba2-7b",
                                  "whisper-tiny"])
def test_a_bad_mesh_gives_the_same_violations(arch):
    rules = rules_for(arch, multi_pod=True, global_batch=256)
    tb, jb = build_model(get_config(arch)), jax_build_model(
        jax_get_config(arch))
    mine = validate_divisibility(_param_shapes(tb), tb.specs(), rules,
                                 BAD_MESH)
    ref = jax_validate_divisibility(
        jax.eval_shape(jb.init, jax.random.PRNGKey(0)), jb.specs(), rules,
        BAD_MESH)
    assert mine and ref
    assert _normalised(mine) == _normalised(ref)
    for shape in SHAPES:
        cell = SHAPES[shape]
        if cell.kind != "decode":
            continue
        mine = validate_divisibility(tb.cache_shapes(cell), tb.cache_specs(),
                                     rules, BAD_MESH)
        ref = jax_validate_divisibility(
            jb.cache_shapes(JAX_SHAPES[shape]), jb.cache_specs(), rules,
            BAD_MESH)
        # the caches keep the stacked layout; jax visits keys sorted
        assert sorted(mine) == sorted(ref)
        specs, axes = tb.input_specs(cell)
        jspecs, jaxes = jb.input_specs(JAX_SHAPES[shape])
        assert sorted(validate_divisibility(specs, axes, rules, BAD_MESH)) \
            == sorted(jax_validate_divisibility(jspecs, jaxes, rules,
                                                BAD_MESH))
