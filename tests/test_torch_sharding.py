"""The port's logical-axis sharding against ``repro``'s: rules, spec
resolution, the param spec trees, the dry run's I/O (``input_specs``,
``cache_shapes``, ``supports``) and the placements they give, for every
arch.  Everything here is exact (strings, shapes and dtypes)."""
import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models.registry import build_model

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


class _AxisNames:
    """What ``repro``'s resolver reads of a mesh: its axis names (jax
    cannot build a 256-device mesh on this host's one CPU device)."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _jax_mesh(name, make_auto_mesh):
    if name == "1x1":
        return make_auto_mesh((1, 1), ("data", "model"))
    return _AxisNames(MESHES[name])


def _is_axes(s):
    return isinstance(s, tuple) or s is None


def _jax_axes_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=_is_axes)


def _all_axes(arch):
    """Every logical-axis tuple of ``repro``'s param, cache and input trees
    of ``arch`` (the paged cache's too, where it has one)."""
    b = jax_build_model(jax_get_config(arch))
    out = set(_jax_axes_leaves(b.specs())) | set(
        _jax_axes_leaves(b.cache_specs()))
    if b.paged_cache_specs is not None:
        out |= set(_jax_axes_leaves(b.paged_cache_specs()))
    for cell in JAX_SHAPES.values():
        out |= set(_jax_axes_leaves(b.input_specs(cell)[1]))
    return sorted(out, key=repr)


def test_the_packages_list_the_same_archs_and_cells():
    assert ALL_ARCHS == JAX_ARCHS
    assert list(SHAPES) == list(JAX_SHAPES)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_equal(multi_pod):
    assert tsh.default_rules(multi_pod) == jsh.default_rules(multi_pod)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_for_equal(arch):
    assert tmesh.ARCH_RULE_OVERRIDES == jmesh.ARCH_RULE_OVERRIDES
    for multi_pod in (False, True):
        for gb in (1, 32, 256):
            for ov in (None, {"seq": "model"}):
                assert tmesh.rules_for(
                    arch, multi_pod=multi_pod, global_batch=gb,
                    overrides=ov) == jmesh.rules_for(
                    arch, multi_pod=multi_pod, global_batch=gb,
                    overrides=ov)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_for_equal_on_every_axes_tuple(arch, mesh_name, make_auto_mesh):
    jm = _jax_mesh(mesh_name, make_auto_mesh)
    multi_pod = "pod" in MESHES[mesh_name]
    for gb in (1, 256):
        rules = tmesh.rules_for(arch, multi_pod=multi_pod, global_batch=gb)
        for axes in _all_axes(arch):
            if axes is None:
                continue
            want = jsh.spec_for(axes, rules, jm)
            got = tsh.spec_for(axes, rules, MESHES[mesh_name])
            assert isinstance(got, tsh.PartitionSpec)
            assert tuple(got) == tuple(want), (axes, got, want)


def test_spec_resolution_and_taken_axes():
    mesh = MESHES["1x1"]
    rules = tsh.default_rules(multi_pod=False)
    assert tsh.spec_for(("embed", "heads"), rules, mesh) == \
        tsh.P("data", "model")
    # mlp loses: model already taken
    assert tsh.spec_for(("heads", "mlp"), rules, mesh) == tsh.P("model", None)
    # pod axis silently dropped on a single-pod mesh
    assert tsh.spec_for(("batch",), tsh.default_rules(True), mesh) == \
        tsh.P("data")
    assert tsh.spec_for(("batch",), tsh.default_rules(True),
                        MESHES["2x16x16"]) == tsh.P(("pod", "data"))
    assert tsh.spec_for(("batch", "heads")) == tsh.P()   # no rules installed


def test_axis_rules_context_is_thread_local_and_nests():
    import threading

    rules = tsh.default_rules()
    seen = []
    with tsh.axis_rules(rules, MESHES["16x16"]):
        assert tsh.current_rules() is rules
        assert tsh.current_mesh() == MESHES["16x16"]
        t = threading.Thread(target=lambda: seen.append(tsh.current_rules()))
        t.start()
        t.join()
        with tsh.axis_rules(None, None):
            assert tsh.current_rules() is None
        assert tsh.spec_for(("embed", "mlp")) == tsh.P("data", "model")
    assert seen == [None]
    assert tsh.current_rules() is None and tsh.current_mesh() is None


class _MeshNames:
    """What ``placements_for`` reads of a DeviceMesh: its dim names."""

    def __init__(self, names):
        self.mesh_dim_names = names


def test_placements_for():
    two = _MeshNames(("data", "model"))
    assert tsh.placements_for(tsh.P("data", "model"), two) == \
        [Shard(0), Shard(1)]
    assert tsh.placements_for(tsh.P(None, "data"), two) == \
        [Shard(1), Replicate()]
    assert tsh.placements_for(tsh.P(), two) == [Replicate(), Replicate()]
    three = _MeshNames(("pod", "data", "model"))
    assert tsh.placements_for(tsh.P(("pod", "data"), None, "model"),
                              three) == [Shard(0), Shard(0), Shard(2)]


def test_logical_constraint_noop_without_rules_or_dtensor():
    x = torch.ones(4, 8)
    assert tsh.logical_constraint(x, "batch", None) is x
    with tsh.axis_rules(tsh.default_rules(), MESHES["16x16"]):
        assert tsh.logical_constraint(x, "batch", None) is x


def _strip(path, n):
    """``repro``'s path of a port leaf: the ``n`` list indices after the
    top-level key dropped."""
    parts = path.split(".")
    return ".".join([parts[0]] + parts[1 + n:])


def _prefix_len(path):
    return 2 if path.startswith("groups.") else (
        1 if path.split(".")[0] in ("layers", "tail", "enc_layers",
                                    "dec_layers") else 0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_without_the_stacked_prefix(arch):
    jspecs = jax_build_model(jax_get_config(arch)).specs()
    jflat = {jsh._path_str_safe(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=_is_axes)[0]}
    tspecs = build_model(get_config(arch)).specs()
    seen = set()
    for path, axes in tsh.spec_leaves(tspecs):
        n = _prefix_len(path)
        key = _strip(path, n)
        assert key in jflat, path
        assert axes == jflat[key][n:], (path, axes, jflat[key])
        seen.add(key)
    assert seen == set(jflat)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_spec_tree_matches_the_params(arch):
    """Every param leaf has a spec of its rank (init under FakeTensorMode:
    shapes only, nothing drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    bundle = build_model(get_config(arch))
    with FakeTensorMode():
        params = bundle.init(0, "cpu")
    ranks = []
    tsh.tree_map_specs(lambda p, leaf, axes: ranks.append(
        (p, leaf.dim(), len(axes))), params, bundle.specs())
    assert ranks and all(a == b for _, a, b in ranks), ranks


def _assert_same_structs(tleaves, jtree):
    jleaves = {jsh._path_str_safe(p): l for p, l in
               jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(tleaves) == set(jleaves)
    for k, t in tleaves.items():
        j = jleaves[k]
        if not isinstance(t, torch.Tensor):
            # the port keeps a cache's shared ``len`` as a Python int
            assert k == "len" and j.shape == () and t == 0, (k, t)
            continue
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(j.shape), (k, t.shape, j.shape)
        want = str(j.dtype)
        assert str(t.dtype).replace("torch.", "") == want, (k, t.dtype, want)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}.{k}" if path else k))
        return out
    return {path: tree}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_cache_shapes_and_supports_equal(arch, shape):
    jb = jax_build_model(jax_get_config(arch))
    tb = build_model(get_config(arch))
    cell = SHAPES[shape]
    assert tb.supports(cell) == jb.supports(JAX_SHAPES[shape])
    tspecs, taxes = tb.input_specs(cell)
    jspecs, jaxes = jb.input_specs(JAX_SHAPES[shape])
    _assert_same_structs(_flat(tspecs), jspecs)
    assert taxes == jaxes
    if cell.kind == "decode":
        _assert_same_structs(_flat(tb.cache_shapes(cell)),
                             jb.cache_shapes(JAX_SHAPES[shape]))
        assert tb.cache_specs() == jb.cache_specs()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shardings_like_and_tree_shardings(arch):
    mesh = MESHES["16x16"]
    rules = tmesh.rules_for(arch, multi_pod=False, global_batch=256)
    bundle = build_model(get_config(arch))
    specs = bundle.specs()
    placed = tsh.tree_shardings(specs, rules, mesh)
    cell = SHAPES["decode_32k"]
    cache = bundle.cache_shapes(cell)
    like = tsh.shardings_like(cache, bundle.cache_specs(), rules, mesh)
    assert set(like) == set(cache)
    for path, axes in tsh.spec_leaves(specs):
        got = placed
        for part in path.split("."):
            got = got[int(part)] if isinstance(got, list) else got[part]
        assert got == tsh.placements_for(tsh.spec_for(axes, rules, mesh),
                                         mesh)
    # dbrx's experts are split over the model axis, their d_model over data
    if arch == "dbrx-132b":
        assert placed["layers"][0]["moe"]["gate"] == [Shard(1), Shard(0)]


# four ranks against one device, f32: the same sums split over ranks and
# reduced in another order; the largest difference measured is 1.0e-5
# (zamba2's f32 SSM state after a decode step), the others 1e-7 - 3e-6
GLOO_TOL = 3e-5


def test_four_gloo_ranks_match_one_device(tmp_path):
    """Reduced qwen3-4b, dbrx-132b (on the sort path, and on the EP path
    at a capacity where no pair drops) and zamba2-7b on a (2, 2) mesh of
    four gloo ranks (tests/torch_gloo_ranks.py, in its own process)
    against one device: the train step's loss and grads (each grad on its
    param's placements), the prefill logits, a decode step's logits and
    cache; and a checkpoint the mesh's loop saved from DTensors, taken up
    by the loop with no mesh."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "gloo.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    done = subprocess.run(
        [sys.executable, os.path.join(root, "tests", "torch_gloo_ranks.py"),
         str(out), str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(out.read_text())
    for arch in ("qwen3-4b", "dbrx-132b", "dbrx-132b-ep", "zamba2-7b"):
        r = result[arch]
        assert r.pop("grad_placements") is True, arch
        for what, err in r.items():
            assert err <= GLOO_TOL, (arch, what, err)
    for what, err in result["checkpoint"].items():
        assert err <= GLOO_TOL, (what, err)


def test_train_launcher_takes_multi_pod_on_one_process(tmp_path, capsys):
    """``--multi-pod`` parses; with one process there is no process group
    and no mesh, and the loop trains on the one device as before."""
    from repro_torch.launch import train as launch_train

    out = launch_train.main([
        "--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "16", "--multi-pod", "--log-every", "1",
        "--ckpt-dir", str(tmp_path)], log=lambda _: None)
    assert len(out["losses"]) == 2 and out["restarts"] == 0
    assert "devices=1" in capsys.readouterr().out


def test_train_launcher_lines_stay_whole_across_processes():
    """Two processes writing the launcher's lines to one pipe with
    unbuffered output (PYTHONUNBUFFERED, as torchrun's ranks may run):
    every line holds one record.  ``print`` writes the text and the
    newline apart, and ran two ranks' ``done:`` lines together under the
    test suite's load."""
    import os
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # both start writing at one moment, after their imports
    code = ("import sys, time\n"
            "from repro_torch.launch.train import _line\n"
            "while time.time() < float(sys.argv[1]): pass\n"
            "for _ in range(2000): _line('done: losses [1] -> [2]')")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               PYTHONUNBUFFERED="1")
    start = str(time.time() + 8)
    read, write = os.pipe()
    procs = [subprocess.Popen([sys.executable, "-c", code, start], env=env,
                              stdout=write) for _ in range(2)]
    os.close(write)
    with os.fdopen(read) as f:
        lines = f.read().splitlines()
    for p in procs:
        assert p.wait(timeout=120) == 0
    assert len(lines) == 4000
    assert all(line == "done: losses [1] -> [2]" for line in lines)


def test_train_launcher_under_torchrun_matches_one_process(tmp_path):
    """``torchrun`` with two gloo ranks: the launcher joins the group,
    builds the (2, 1) mesh and trains on DTensors; each rank's losses
    equal the one-process run's within GLOO_TOL, and the checkpoints are
    written once."""
    import os
    import re
    import subprocess
    import sys

    from repro_torch.launch import train as launch_train

    args = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--log-every",
            "1", "--ckpt-every", "2"]
    one = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "one")],
                            log=lambda _: None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    # --standalone: torchrun's rendezvous binds a port of its own choosing
    # when it starts; a port chosen here and freed would stay open to any
    # other process until torchrun, seconds later, bound it
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *args, "--ckpt-dir", str(tmp_path / "two")],
        env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.count("mesh={'data': 2, 'model': 1}") == 2
    finals = re.findall(r"done: losses \[.*\] -> \[(.*)\]", done.stdout)
    assert len(finals) == 2
    want = one["losses"][-2:]
    for line in finals:
        got = [float(x) for x in line.split(",")]
        assert max(abs(a - b) for a, b in zip(got, want)) <= GLOO_TOL
    assert sorted(os.listdir(tmp_path / "two")) == [
        "step_0000000002", "step_0000000003"]
