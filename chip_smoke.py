#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. a CUDA device must be present; the card's name and power limit are read
   with nvidia-smi;
2. the port's CUDA sources are built (repro_torch/_build.py, nvcc for
   sm_90a), and the build seconds printed;
3. each kernel is held against its plain PyTorch version on the card at the
   decode shapes of qwen3-4b and qwen2-0.5b, f32 and bf16, with mixed
   kv_len (1, S, and lengths that are no multiple of any tile), and timed
   beside the plain version and PyTorch's scaled_dot_product_attention;
4. qwen3-4b at its published widths (bf16, random weights from a seed) is
   served: first through the launcher (repro_torch.launch.serve.main), then
   through a ServeEngine with 8 slots and a 1024-token cache answering 16
   requests with prompts of 32-700 tokens.  Every request must finish; the
   kernel's launch count over that run must equal decode_steps x layers;
   one decode step's logits must match the same step with the attention
   swapped for the plain version.  The share of requests whose greedy
   tokens equal the one-request oracle (greedy_reference) is reported, not
   gated: cuBLAS may pick other GEMM algorithms at batch 1 and batch 8.
5. the last lines are the card (nvidia-smi), a JSON line of every kernel
   with its launches, error and times, and the JSON result line.

TF32 is switched off for matmuls and cuDNN, so that f32 comparisons on the
card mean full f32.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and flop/s by
# operand type; a kernel's bound is the larger of bytes/BW and flops/peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# kernel vs plain tolerances: f32 sums in another order (1e-5); bf16 output
# rounding can land on either side of a tie (2e-2)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# logits of one full-width decode step, kernel vs plain attention, bf16 end
# to end, as a normwise relative error ||a - b|| / ||b||: bf16 keeps 8
# significant bits (2^-8 relative rounding), and a one-ulp difference in an
# attention output is re-rounded through 36 layers; 2e-2 allows a few ulps
# at the scale of the whole logit vector.  (An elementwise 2e-2 gate failed
# on the card: one logit moved by 0.0625, a bf16 ulp or two at the
# logits' scale.  The same step with PyTorch's own attention swapped in is
# printed beside it for scale.)
LOGIT_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, reps: int = 20) -> float:
    """Device ms per call: the calls over ``arg_sets`` are captured once
    in a CUDA graph and replayed, timed with CUDA events, so host-side
    launch cost (Python, ctypes) does not hide in the number.  Cycling
    through ``arg_sets`` makes successive calls read different memory that
    the 50 MB L2 does not hold, as in a forward pass over many layers."""
    import torch
    for args in arg_sets[:2]:            # lazy init outside the capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def eager_ms(fn, arg_sets, iters: int = 60) -> float:
    """Wall ms per eager call, host launch cost included (CUDA events
    around a loop the host may not run ahead of)."""
    import torch
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, kv_len) -> tuple:
    """Least time for one decode attention call on these inputs: each
    input byte read once (K/V only up to kv_len), the output written once;
    4*H*hd flops per valid position (q.k and p.v)."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    item = q.element_size()
    n_valid = int(kv_len.clamp(max=k.shape[1]).sum())
    nbytes = (2 * q.numel() * item + 2 * n_valid * kvh * hd * item
              + kv_len.numel() * 4)
    flops = 4 * h * hd * n_valid
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, kv_len):
    """PyTorch's own attention on the same inputs (timed as the yardstick,
    never used by the port)."""
    import torch
    import torch.nn.functional as F
    b, h, hd = q.shape
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0]


def phase_kernels(torch, decode_attention, decode_attention_ref) -> None:
    """Kernel vs plain version at the decode shapes of both served models."""
    shapes = {"qwen3-4b": (32, 8, 128), "qwen2-0.5b": (14, 2, 64)}
    b, s = 8, 1024
    lens = [1, s, 37, 129, 400, 700, 1000, 255]
    for model, (h, kvh, hd) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            # enough copies of the cache that the timed loop misses in L2
            per = 2 * b * s * kvh * hd * dtype.itemsize
            n_sets = max(2, -(-200_000_000 // per))
            sets = [(torch.randn(b, h, hd, generator=gen, device="cuda",
                                 dtype=dtype),
                     torch.randn(b, s, kvh, hd, generator=gen,
                                 device="cuda", dtype=dtype),
                     torch.randn(b, s, kvh, hd, generator=gen,
                                 device="cuda", dtype=dtype), kv_len)
                    for _ in range(n_sets)]
            got = decode_attention(*sets[0])
            want = decode_attention_ref(*sets[0])
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(),
                                  rtol=TOL[name], atol=TOL[name]):
                raise RuntimeError(f"decode_attention {model} {name}: kernel "
                                   f"disagrees with plain, max err {err}")
            sdpa_err = float((sdpa_call(*sets[0]).float()
                              - want.float()).abs().max())
            ms = time_ms(decode_attention, sets)
            plain_ms = time_ms(decode_attention_ref, sets)
            lib_ms = time_ms(sdpa_call, sets)
            host_ms = eager_ms(decode_attention, sets)
            bound, by = attention_bound_ms(*sets[0][:2], kv_len)
            log(f"[kernel] decode_attention {model} {name} B={b} S={s} "
                f"H={h} KVH={kvh} hd={hd} kv_len={lens}: max_abs_err={err:.3g}"
                f" (tol {TOL[name]}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"sdpa_ms={lib_ms:.4f} (sdpa err {sdpa_err:.3g}) "
                f"bound_ms={bound:.4f} ({by}); eager call with host "
                f"launch cost {host_ms:.4f} ms")
            del sets


def phase_serve(torch, device: str = "cuda", reduced: bool = False):
    """Full-width qwen3-4b through the launcher and the engine (``device``
    and ``reduced`` let the flow be rehearsed on the CPU at toy size)."""
    import dataclasses

    import numpy as np

    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import build_model
    from repro_torch.serve import (
        EngineConfig,
        ServeEngine,
        ServeRequest,
        greedy_reference,
    )

    log(f"[serve] launcher: repro_torch.launch.serve.main --arch qwen3-4b "
        f"{'--reduced' if reduced else '--no-reduced'} --engine")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", "qwen3-4b",
                       "--reduced" if reduced else "--no-reduced", "--engine",
                       "--device", device, "--seed", str(SEED)])
    log(f"[serve] launcher done in {time.perf_counter() - t0:.1f}s")

    cfg = (reduced_config if reduced else get_config)("qwen3-4b")
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["unembed"]]
                   + [x for lp in params["layers"] for d in lp.values()
                      for x in d.values()]
                   + list(params["final_norm"].values()))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f}s")

    slots, cache_len, max_new = 8, 1024, 16
    rng = np.random.default_rng(SEED)
    prompt_lens = [int(n) for n in
                   rng.permutation(np.linspace(32, 700, 16).astype(int))]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lens]

    def requests():
        return [ServeRequest(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]

    engine = ServeEngine(bundle, params, EngineConfig(
        slots=slots, cache_len=cache_len, pad_to=8, max_prefill_batch=8),
        device=device)
    engine.run(requests())                       # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    decode_attention.launches = 0
    t0 = time.perf_counter()
    done = engine.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    stats = engine.stats()
    if len(done) != 16 or not all(r.done and len(r.out) == max_new
                                  for r in done):
        raise RuntimeError("not every request finished with its tokens")
    want = stats["decode_steps"] * cfg.n_layers
    if launches != want:
        raise RuntimeError(f"decode_attention launched {launches} times, "
                           f"want decode_steps x layers = {want}")
    tokens = sum(len(r.out) for r in done)

    # the same run once more, each prefill and decode call synchronised and
    # timed, to split the wall time between them
    split = {"prefill": [0, 0.0], "decode": [0, 0.0]}

    def timed(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[name][0] += 1
            split[name][1] += time.perf_counter() - t
            return out
        return call

    ServeEngine(dataclasses.replace(
        bundle, prefill_slotted=timed("prefill", bundle.prefill_slotted),
        decode_slotted=timed("decode", bundle.decode_slotted)), params,
        engine.cfg, device=device).run(requests())
    log("[serve] split: " + ", ".join(
        f"{k} {n} calls {t:.3f}s ({1e3 * t / max(n, 1):.2f} ms/call)"
        for k, (n, t) in split.items()))
    log(f"[serve] engine: {len(done)} requests, prompts {sorted(prompt_lens)}"
        f", max_new {max_new}, slots {slots}, cache_len {cache_len}: "
        f"{tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s; "
        f"stats {stats}; decode_attention launches {launches} "
        f"(= {stats['decode_steps']} x {cfg.n_layers})")

    # one mid-run decode step, kernel vs plain attention, same state
    engine.reset()
    for r in requests():
        engine.submit(r)
    while engine.decode_steps < 6:
        engine.tick(float(engine.decode_steps))
    active = torch.tensor([r is not None for r in engine.active],
                          device=device)
    batch = {"tokens": torch.as_tensor(engine.last_tok[:, None],
                                       device=device), "active": active}
    snap = {k: v.clone() for k, v in engine.cache.items()}
    logits_k, _ = bundle.decode_slotted(
        params, {k: v.clone() for k, v in snap.items()}, batch)
    other = {}
    for name, attn in (("plain", decode_attention_ref), ("sdpa", sdpa_call)):
        attention_mod.decode_attention = attn
        try:
            other[name], _ = bundle.decode_slotted(
                params, {k: v.clone() for k, v in snap.items()}, batch)
        finally:
            attention_mod.decode_attention = decode_attention
    if not torch.isfinite(logits_k).all():
        raise RuntimeError("non-finite logits in the served decode step")
    lk = logits_k.float()[active]
    lp, ls = other["plain"].float()[active], other["sdpa"].float()[active]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    step_rel, step_err = rel(lk, lp), float((lk - lp).abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"[serve] decode step {engine.decode_steps}: logits kernel vs plain "
        f"attention: rel_err={step_rel:.4g} (tol {LOGIT_TOL}) "
        f"max_abs_err={step_err:.4g} argmax agreement {agree:.3f}; sdpa vs "
        f"plain: rel_err={rel(ls, lp):.4g} max_abs_err="
        f"{float((ls - lp).abs().max()):.4g}; |logits| max "
        f"{float(lp.abs().max()):.3g}")
    if not step_rel <= LOGIT_TOL:
        raise RuntimeError(f"decode-step logits, kernel vs plain attention: "
                           f"relative error {step_rel} over {LOGIT_TOL}")

    # where three decode steps' device time goes (torch.profiler, CUPTI)
    from torch.profiler import ProfilerActivity, profile
    state = {k: v.clone() for k, v in snap.items()}
    bundle.decode_slotted(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            _, state = bundle.decode_slotted(params, state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del state

    # device busy: the kernels (and copies) the profiler saw on the card;
    # idle share against the unprofiled decode step of the split above
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    step_ms = 1e3 * split["decode"][1] / max(split["decode"][0], 1)
    if not kernels:
        log("[profile] the profiler recorded no device kernels: device busy "
            "and idle share not measured")
    else:
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 3e3
        by_name = {}
        for e in kernels:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
        log(f"[profile] decode step: device busy {busy_ms:.3f} ms/step over "
            f"{len(kernels) // 3} kernels/step; unprofiled step "
            f"{step_ms:.3f} ms -> device idle share "
            f"{1 - busy_ms / step_ms:.3f} (wall under the profiler "
            f"{wall_us / 3e3:.3f} ms/step)")
        for name, (n, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"[profile]   {t / 3e3:8.4f} ms/step {n // 3:5d}/step  "
                f"{name[:90]}")

    # the kernel at the main path's own inputs: this step's per-layer
    # caches (distinct memory per layer, as in a forward pass)
    kv_len = snap["lens"] + 1
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(slots, cfg.n_heads, cfg.resolved_head_dim,
                    generator=gen, device=device, dtype=snap["k"].dtype)
    sets = [(q, snap["k"][i], snap["v"][i], kv_len)
            for i in range(cfg.n_layers)]
    got = decode_attention(*sets[0])
    ref = decode_attention_ref(*sets[0])
    path_err = float((got.float() - ref.float()).abs().max())
    if not torch.allclose(got.float(), ref.float(), rtol=TOL["bfloat16"],
                          atol=TOL["bfloat16"]):
        raise RuntimeError(f"kernel vs plain at the main path's inputs: "
                           f"max err {path_err}")
    bound, by = attention_bound_ms(q, snap["k"][0], kv_len)
    path = dict(err=path_err, ms=time_ms(decode_attention, sets),
                plain_ms=time_ms(decode_attention_ref, sets),
                library_ms=time_ms(sdpa_call, sets), bound_ms=bound,
                bound_by=by, kv_len=kv_len.tolist(),
                host_ms=eager_ms(decode_attention, sets))
    log(f"[kernel] decode_attention at the main path's step "
        f"{engine.decode_steps} (B={slots} S={cache_len} H={cfg.n_heads} "
        f"KVH={cfg.n_kv_heads} hd={cfg.resolved_head_dim} {cfg.dtype}, "
        f"kv_len "
        f"{path['kv_len']}): max_abs_err={path_err:.3g} ms={path['ms']:.4f} "
        f"plain_ms={path['plain_ms']:.4f} sdpa_ms={path['library_ms']:.4f} "
        f"bound_ms={bound:.4f} ({by}); eager call with host launch cost "
        f"{path['host_ms']:.4f} ms; {cfg.n_layers} launches per decode step")
    del sets, snap

    # greedy parity with the one-request oracle: reported, not gated
    same = 0
    for r in done:
        ref_toks = greedy_reference(bundle, params, r.prompt, r.max_new,
                                    cache_len, device=device)
        same += ref_toks == r.out
    log(f"[serve] greedy tokens equal to greedy_reference: {same}/{len(done)}"
        f" requests (reported, not gated)")
    return launches, path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import _build
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {built or 'already built'} in "
        f"{time.perf_counter() - t0:.1f}s -> {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            text = report.read_text()
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
            spills = re.findall(r"(\d+) bytes spill stores", text)
            log(f"[build] {name}: {len(regs)} kernels, registers "
                f"{min(regs, default=0)}-{max(regs, default=0)}, spill "
                f"stores {sorted({int(x) for x in spills})} bytes")
    t_total = time.perf_counter()

    phase_kernels(torch, decode_attention, decode_attention_ref)
    launches, path = phase_serve(torch)

    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:67",
        "launches": launches,
        "max_abs_err": path["err"],
        "ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
    }]
    log(f"[done] phases 3-4 in {time.perf_counter() - t_total:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
