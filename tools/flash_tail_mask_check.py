#!/usr/bin/env python3
"""What the flash kernel's checks read with and without the mask of the
keys past Sk, on one card.  Run from the repository root on the GPU
machine:

    python3 tools/flash_tail_mask_check.py

TMA zero-fills the key rows past Sk in the last tile a block reads (the
f32 kernel fills them with zeros itself); the kernel masks them on both
of its paths.  This script builds ``csrc/flash_attention.cu`` twice with
nvcc (the port's flags) into a temporary directory: as it is, and with
that mask taken out by a text edit of the source (the causal mask stays).
Each library is loaded with ctypes and called through the port's
``flash_attention`` op on the same card tensors, and every output is held
to ``flash_attention_ref``: the largest elementwise error, whether it
passes ``allclose`` at ``chip_smoke.TOL``, and the normwise error
||got - want|| / ||want|| that ``chip_smoke.FLASH_NORM_TOL`` limits.

Inputs: phase 3c's unmasked cases (``chip_smoke.FLASH_FULL_CASES``) and
phase 3b's causal ones (``FLASH_SHAPES`` x ``FLASH_LENGTHS``, bf16 and
f32), two draws each from ``chip_smoke.SEED``; then every launch of one
whisper-tiny prefill at phase 15's shapes (8 x 1,500 frames, a 4-token
prompt, random weights from SEED).  Prints the card first, one line per
case and build, and the largest normwise reading of each build by dtype.
"""
from __future__ import annotations

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
# the mask of the keys past Sk taken out of both paths, the causal one kept
NO_TAIL_MASK = [
    ("if (last && (key >= Sk || (causal && key > row))) sc[i] = -INFINITY;",
     "if (last && causal && key > row) sc[i] = -INFINITY;"),
    ("if (kj >= Sk || (causal && kj > qi)) s[i][j] = -INFINITY;",
     "if (causal && kj > qi) s[i][j] = -INFINITY;"),
]
BUILDS = {"sound": [], "no tail mask": NO_TAIL_MASK}


def build(work: Path, name: str, edits) -> "ctypes._CFuncPtr":
    """flash_attention.cu with ``edits`` (old, new) applied, built and
    loaded: its C entry point, typed as the op's launcher types it."""
    out = work / name.replace(" ", "_")
    out.mkdir()
    shutil.copy(CSRC / "hopper.cuh", out)
    text = (CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source has no {old!r}")
        text = text.replace(old, new)
    (out / "flash_attention.cu").write_text(text)
    with open(out / "log", "w") as log:
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out / "lib.so"), str(out / "flash_attention.cu")],
                       stdout=log, stderr=subprocess.STDOUT, check=True)
    fn = ctypes.CDLL(str(out / "lib.so")).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def cases(torch):
    """(label, dtype name, [(q, k, v, causal), ...]) for every case."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def draw(b, sq, sk, h, kvh, hd, dt, causal):
        dtype = getattr(torch, dt)
        return [(torch.randn(b, sq, h, hd, generator=gen, device="cuda",
                             dtype=dtype),
                 *(torch.randn(b, sk, kvh, hd, generator=gen, device="cuda",
                               dtype=dtype) for _ in range(2)), causal)
                for _ in range(2)]
    for name, (b, sq, sk, h, kvh, hd, dt) in cs.FLASH_FULL_CASES.items():
        yield (f"3c {name} B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} hd={hd}",
               dt, draw(b, sq, sk, h, kvh, hd, dt, False))
    for model, (h, kvh, hd) in cs.FLASH_SHAPES.items():
        for s in cs.FLASH_LENGTHS:
            for dt in ("float32", "bfloat16"):
                yield (f"3b {model} causal S={s} H={h} KVH={kvh} hd={hd}",
                       dt, draw(1, s, s, h, kvh, hd, dt, True))


def read(torch, sets, dt) -> tuple:
    """The op against its plain version on every set: (largest elementwise
    error, largest normwise error, every set passes allclose at TOL)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    err, rel, close = 0.0, 0.0, True
    for q, k, v, causal in sets:
        got = flash_attention(q, k, v, causal)
        want = flash_attention_ref(q, k, v, causal)
        e, r = cs.flash_errors(got, want)
        close &= bool(torch.allclose(got.float(), want.float(),
                                     rtol=cs.TOL[dt], atol=cs.TOL[dt]))
        err, rel = max(err, e), max(rel, r)
    return err, rel, close


def main() -> int:
    import torch

    import repro_torch.kernels.flash_attention.ops as ops
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: build(Path(tmp), name, edits)
               for name, edits in BUILDS.items()}
        cfg, bundle, params = cs.load_model(torch, "cuda", False,
                                            cs.ENCDEC_ARCH)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        run = cs.ENCDEC_RUN
        batch = {"frames": torch.randn(
                     run["batch"], run["frames"], cfg.d_model, generator=gen,
                     device="cuda").to(getattr(torch, cfg.dtype)),
                 "dec_tokens": torch.randint(
                     0, cfg.vocab_size, (run["batch"], run["prompt"]),
                     generator=gen, device="cuda"),
                 "cache_len": run["cache_len"]}
        for label, dt, sets in cases(torch):
            for name, fn in fns.items():
                ops._launcher = lambda fn=fn: fn
                err, rel, close = read(torch, sets, dt)
                worst[(name, dt)] = max(worst.get((name, dt), 0.0), rel)
                print(f"{label} {dt} [{name}]: max_abs_err {err:.4g} "
                      f"(allclose at {cs.TOL[dt]}: {close}), normwise "
                      f"{rel:.4g}", flush=True)
            del sets
        for name, fn in fns.items():
            ops._launcher = lambda fn=fn: fn
            _, _, calls = cs.recorded_prefill(torch, bundle, params, batch)
            for mask in (False, True):
                got = [c for c in calls if c[3] == mask]
                err, rel, close = read(torch, [c[:4] for c in got],
                                       cfg.dtype)
                worst[(name, cfg.dtype)] = max(worst[(name, cfg.dtype)],
                                               rel)
                print(f"15 {cs.ENCDEC_ARCH} prefill, its {len(got)} "
                      f"{'causal' if mask else 'unmasked'} launches "
                      f"{cfg.dtype} [{name}]: max_abs_err {err:.4g} "
                      f"(allclose at {cs.TOL[cfg.dtype]}: {close}), "
                      f"normwise {rel:.4g}", flush=True)
            del calls
    for (name, dt), rel in sorted(worst.items()):
        print(f"largest normwise [{name}] {dt}: {rel:.4g} (FLASH_NORM_TOL "
              f"{cs.FLASH_NORM_TOL[dt]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
