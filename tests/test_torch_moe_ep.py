"""The port's expert-parallel MoE path against ``repro``'s ``moe_block_ep``.

One spawn of tests/torch_ep_ranks.py (4 gloo ranks, the port on DTensors)
and one subprocess of tests/torch_ep_reference.py (``repro`` on 4 forced
host devices) serve the module; both run the cases of
tests/torch_ep_cases.py on the same numpy inputs, on (2, 2) and (1, 4)
("data", "model") meshes.

Tolerances, f32: y within 1e-5 and aux within 1e-6 (measured at most
2.2e-6 and 1.2e-7); each gradient within 2e-6 of its largest magnitude
(measured at most 4e-7: the two packages sum in other orders).  The
reference's meshes have Auto axes, where its gradients with a shared
expert trace; on jax 0.9's default Explicit axes they raise
(tests/test_ep_moe.py), so the shared expert's gradients are also held
to the port's own sort path where no pair drops.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ep_cases import CASES, case_inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y_TOL, AUX_TOL, GRAD_RTOL = 1e-5, 1e-6, 2e-6
# (rank, buckets, capacity, rows, valid rows, kept rows) of each dispatch
_VALID, _KEPT = 4, 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's results, the reference's), each an npz."""
    tmp = tmp_path_factory.mktemp("ep")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", script),
         str(tmp / f"{tag}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for tag, script in (("port", "torch_ep_ranks.py"),
                            ("ref", "torch_ep_reference.py"))]
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    return np.load(tmp / "port.npz"), np.load(tmp / "ref.npz")


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _dropped(stages, buckets=None):
    """Real rows a forward's dispatches dropped (of one stage: buckets)."""
    rows = stages if buckets is None else stages[stages[:, 1] == buckets]
    return int((rows[:, _VALID] - rows[:, _KEPT]).sum())


@pytest.mark.parametrize("case", [c for c in CASES if c != "2x2_cloc0"])
def test_forward_matches_reference(runs, case):
    port, ref = runs
    _close(port[f"{case}/y"], ref[f"{case}/y"], Y_TOL, "y")
    _close(port[f"{case}/aux"], ref[f"{case}/aux"], AUX_TOL, "aux")
    if CASES[case][1].get("capacity_factor") == 1.0 and port[f"{case}/ep"]:
        # EP's per-rank bounds bite here: the case tests the drop order
        assert _dropped(port[f"{case}/stages"]) > 0


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][4]])
def test_grads_match_reference(runs, case):
    port, ref = runs
    names = [k.split("/")[-1] for k in ref.files
             if k.startswith(f"{case}/grad/")]
    assert len(names) == (7 if "unshared" not in case else 4)
    for k in names:
        want = ref[f"{case}/grad/{k}"]
        _close(port[f"{case}/grad/{k}"], want,
               GRAD_RTOL * float(np.abs(want).max()), k)


@pytest.mark.parametrize("case", list(CASES))
def test_path_is_repros_choice(runs, case):
    """EP where the sequence divides the experts axis ("model"), the sort
    path elsewhere: S 16 on either mesh takes EP, S 1 on (1, 4) does not."""
    port, _ = runs
    mesh, _, shape, _, _ = CASES[case]
    assert int(port[f"{case}/ep"]) == (shape[1] % mesh[1] == 0)


@pytest.mark.parametrize("case", ["2x2_cf8", "1x4_cf8"])
def test_ep_equals_sort_path_where_nothing_drops(runs, case):
    """With the shared expert, at capacity 8.0: EP on the mesh against
    the port's one-device sort path, values and every gradient."""
    port, _ = runs
    assert _dropped(port[f"{case}/stages"]) == 0
    _close(port[f"{case}/y"], port[f"{case}/sort/y"], Y_TOL, "y")
    _close(port[f"{case}/aux"], port[f"{case}/sort/aux"], AUX_TOL, "aux")
    for k in [f.split("/")[-1] for f in port.files
              if f.startswith(f"{case}/sort/grad/")]:
        want = port[f"{case}/sort/grad/{k}"]
        _close(port[f"{case}/grad/{k}"], want,
               GRAD_RTOL * float(np.abs(want).max()), k)


def test_c_loc_zero_leaves_the_shared_expert_alone(runs):
    """Capacity 0.2 on (2, 2): c_send 8, c_loc 0, so every routed pair
    drops and y is the shared expert's output alone.  ``repro``'s
    ``moe_block_ep`` computes the same capacities but does not trace
    there (its combine gathers from an empty buffer), so y is held to the
    shared expert computed here."""
    port, ref = runs
    assert int(ref["2x2_cloc0/raised"]) == 1
    stages = port["2x2_cloc0/stages"]
    second = stages[stages[:, 1] == 4]           # e_loc 4 local experts
    assert (second[:, 2] == 0).all() and (second[:, _KEPT] == 0).all()
    _, p, x = case_inputs("2x2_cloc0")

    def silu(a):
        return a / (1 + np.exp(-a))
    xf = x.astype(np.float64)
    want = (silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])) \
        @ p["shared_down"]
    _close(port["2x2_cloc0/y"], want, Y_TOL, "y")


def test_empty_slots_take_places_of_local_expert_0(runs):
    """Capacity 1.0 on (1, 4): a source rank's empty slots sort as local
    expert 0 ahead of a later source's expert-0 rows and push some of
    them past c_loc.  The port drops those rows, as ``repro`` does (y
    equal); sorting the empty slots last instead keeps more rows and
    gives another y."""
    port, ref = runs
    kept = port["1x4_empty/stages"][:, _KEPT].sum()
    kept_no_empty = port["1x4_empty/no_empty/stages"][:, _KEPT].sum()
    assert kept_no_empty > kept
    _close(port["1x4_empty/y"], ref["1x4_empty/y"], Y_TOL, "y")
    assert np.abs(port["1x4_empty/no_empty/y"]
                  - ref["1x4_empty/y"]).max() > 0.1
