"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics and the device's busy time
from ``torch.profiler``.  ``--control`` also prints what the check reads
for the reference in float8 put in the program's place (the control of
``portbench/limits``), and is not part of a benchmark run.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``: each number compared with its
limit.  The last lines of standard error repeat the checks.  Without a
card, or with fewer than the cell asks for, it exits 2 and prints no
result; if JAX was loaded, 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's nvcc libraries already go to ``build/repro_torch/``."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    from portbench.harness import spec as S

    cell = S.resolve_cell(S.load_spec(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test)
    from portbench.harness import bench, trace as T

    torch.cuda.set_device(0)
    # one thread of host compute: the engine's host work is Python and
    # numpy, and idle intra-op workers would only contend for the cores
    # that launch the kernels
    torch.set_num_threads(1)
    card = T.power_limit()
    bench.log(f"[card] {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}")
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, control=args.control)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["peak"],
              "power_limit": card}
    if args.trace:
        device["busy_s"] = out.get("busy_s", 0.0)
        device["window_s"] = out.get("window_s", 0.0)
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device, "check_s": out["check_s"],
              "compared_tokens": out["compared_tokens"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    if "control" in out:
        result["control"] = out["control"]
    if "check_error" in out:
        result["check_error"] = out["check_error"]
    result["checks"] = out["checks"]
    if "check_error" in out:
        bench.log(f"[check] not compared: {out['check_error']}")
    for name, c in out["checks"].items():
        bench.log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
