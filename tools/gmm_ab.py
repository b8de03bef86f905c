#!/usr/bin/env python3
"""A/B of the grouped-matmul kernels on one card, and the dW kernel's parts
timed apart.  Run from the repository root on the GPU machine:

    python3 tools/gmm_ab.py [--other DIR]

``DIR`` holds another tree's ``moe_gmm.cu`` and ``hopper.cuh`` (its
``src/repro_torch/csrc``; e.g. unpacked from ``git archive <commit>
src/repro_torch/csrc``).  Every library is built with nvcc (the port's
flags) into a temporary directory, loaded with ctypes and called on the
same card tensors, in turns (this, other, other, this), each time the
device ms per call by CUDA-graph replay (``chip_smoke.time_ms``):

* the decode product at dbrx-132b's (16, 8, 6144, 10752) and (16, 8,
  10752, 6144) bf16, beside torch.bmm and the bound;
* the backward at (16, 224, 6144, 10752) bf16: this tree's two launches,
  the other tree's backward (its ``moe_gmm_backward_launch`` where it has
  one, else the transposed copies and forward launches an older
  ``GroupedMatmul.backward`` ran), torch.bmm's two products and the bound;
* this tree's dW kernel built three more times with parts of it switched
  off by text edits of the source: the stores alone (no products, no dY
  loads), the dY loads alone (no products, no stores) and the products
  alone (no stores, no dY loads), to show which part bounds it.

Prints one line per measurement and the card (nvidia-smi) first.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
NO_PRODUCTS = ("hopper::wgmma_ss_n128<1, 1>(",
               "if (false) hopper::wgmma_ss_n128<1, 1>(")
NO_STORES = ("hopper::tma_store_3d(&omap, out_s,",
             "if (false) hopper::tma_store_3d(&omap, out_s,")
NO_LOADS = [("hopper::mbar_expect_tx(&full[s], kBStage);",
             "hopper::mbar_arrive(&full[s]);"),
            ("hopper::tma_load_3d(bs + s * kBStage, &dymap",
             "if (false) hopper::tma_load_3d(bs + s * kBStage, &dymap"),
            ("hopper::tma_load_3d(bs + s * kBStage + kChunkBytes, &dymap",
             "if (false) hopper::tma_load_3d(bs + s * kBStage + kChunkBytes,"
             " &dymap")]
PARTS = {"stores alone": [NO_PRODUCTS] + NO_LOADS,
         "dY loads alone": [NO_PRODUCTS, NO_STORES],
         "products alone": [NO_STORES] + NO_LOADS}


def build(src_dir: Path, work: Path, name: str, edits=()) -> ctypes.CDLL:
    """``src_dir``'s moe_gmm.cu, with ``edits`` (old, new) applied, built
    and loaded; ``work / name`` keeps the source, library and log."""
    out = work / name
    out.mkdir()
    shutil.copy(src_dir / "hopper.cuh", out)
    text = (src_dir / "moe_gmm.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source has no {old!r}")
        text = text.replace(old, new)
    (out / "moe_gmm.cu").write_text(text)
    with open(out / "log", "w") as log:
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out / "lib.so"), str(out / "moe_gmm.cu")],
                       stdout=log, stderr=subprocess.STDOUT, check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    tail = [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.moe_gmm_launch.argtypes = [ctypes.c_void_p] * 3 + tail
    if hasattr(lib, "moe_gmm_backward_launch"):
        lib.moe_gmm_backward_launch.argtypes = \
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + tail
    return lib


def calls(torch, lib):
    """(forward(x, w), backward(x, w, dy) -> (dx, dw), dw(x, w, dy))
    through ``lib``; dw is the one launch of dW = X^T dY."""
    def launch(fn, *args):
        path = ctypes.c_int(-1)
        err = fn(*args, torch.cuda.current_stream().cuda_stream,
                 ctypes.byref(path))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def forward(x, w):
        e, c, d = x.shape
        out = torch.empty(e, c, w.shape[2], dtype=x.dtype, device=x.device)
        launch(lib.moe_gmm_launch, x.data_ptr(), w.data_ptr(),
               out.data_ptr(), e, c, d, w.shape[2], 1)
        return out

    def backward(x, w, dy):
        e, c, d = x.shape
        f = w.shape[2]
        if not hasattr(lib, "moe_gmm_backward_launch"):
            def t(a):
                return a.transpose(1, 2).contiguous()
            return t(forward(w, t(dy))), forward(t(x), dy)
        dx = torch.empty_like(x)
        launch(lib.moe_gmm_backward_launch, 0, dy.data_ptr(), w.data_ptr(),
               dx.data_ptr(), e, c, d, f, 1)
        return dx, dw_only(x, w, dy)

    def dw_only(x, w, dy):
        e, c, d = x.shape
        dw = torch.empty_like(w)
        launch(lib.moe_gmm_backward_launch, 1, x.data_ptr(), dy.data_ptr(),
               dw.data_ptr(), e, c, d, w.shape[2], 1)
        return dw
    return forward, backward, dw_only


def turns(fns: dict, sets) -> dict:
    """Device ms per call of each fn, timed in turns there and back."""
    out = {}
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            out.setdefault(name, []).append(cs.time_ms(fns[name], sets))
    return {k: round(sum(v) / len(v), 4) for k, v in out.items()}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, default=None,
                    help="a csrc directory with another moe_gmm.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gmm_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        libs = {"this": build(CSRC, work, "this")}
        if args.other is not None:
            libs["other"] = build(args.other, work, "other")
        parts = {name: build(CSRC, work, name.replace(" ", "_"), edits)
                 for name, edits in PARTS.items()}
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for shape in ((16, 8, 6144, 10752), (16, 8, 10752, 6144)):
            sets = [cs.gmm_inputs(torch, *shape, torch.bfloat16, "cuda", gen)
                    for _ in range(3)]
            want = torch.bmm(*sets[0])
            fns = {}
            for name, lib in libs.items():
                fns[name] = calls(torch, lib)[0]
                rel = cs.rel_err(fns[name](*sets[0]), want)
                if rel > cs.GMM_NORM_TOL["bfloat16"]:
                    raise RuntimeError(f"decode {name}: normwise {rel}")
            fns["bmm"] = cs.bmm_call
            print(f"decode {shape} bf16 ms {turns(fns, sets)} bound "
                  f"{cs.gmm_bound_ms(*sets[0])[0]:.4f}", flush=True)
            del sets, want
        e, c, d, f = 16, 224, 6144, 10752
        x, w = cs.gmm_inputs(torch, e, c, d, f, torch.bfloat16, "cuda", gen)
        dy = torch.randn(e, c, f, generator=gen, device="cuda").to(
            torch.bfloat16)
        sets = [(x, w, dy)]
        fns = {name: calls(torch, lib)[1] for name, lib in libs.items()}
        fns["bmm"] = cs.bmm_backward_call
        dx, dw = fns["this"](x, w, dy)
        for what, got, want in (("dX", dx, torch.bmm(dy, w.transpose(1, 2))),
                                ("dW", dw, torch.bmm(x.transpose(1, 2), dy))):
            rel = cs.rel_err(got, want)
            if rel > cs.GMM_NORM_TOL["bfloat16"]:
                raise RuntimeError(f"backward {what}: normwise {rel}")
        del dx, dw
        with torch.no_grad():
            print(f"backward {(e, c, d, f)} bf16 ms {turns(fns, sets)} "
                  f"bound {cs.gmm_grad_bound_ms(x, w)[0]:.4f}", flush=True)
            dw_fns = {"dW": calls(torch, libs["this"])[2]}
            for name, lib in parts.items():
                dw_fns[f"dW, {name}"] = calls(torch, lib)[2]
            dw_fns["dW, bmm"] = lambda x_, w_, dy_: torch.bmm(
                x_.transpose(1, 2), dy_)
            print(f"dW {(e, c, d, f)} bf16 parts ms {turns(dw_fns, sets)} "
                  f"bound {cs.gmm_grad_bound_ms(x, w, ('dw',))[0]:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
