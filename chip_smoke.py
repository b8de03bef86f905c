#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. a CUDA device must be present; the card's name and power limit are read
   with nvidia-smi;
2. the port's CUDA sources are built (repro_torch/_build.py, nvcc for
   sm_90a), and the build seconds printed, with each tensor-core kernel's
   registers and spills (none may spill), ptxas's wgmma serialisation
   warnings (none allowed) and the wgmma (HGMMA) instructions in the
   flash and gmm libraries' SASS (cuobjdump; some must be there); the
   decode kernels' registers and spills (none may spill), their cluster
   size, and the mma.sync (HMMA) instructions of their bf16 path (some
   must be there); likewise every instantiation of the SSD scan (none may
   spill; its chunked path's HMMA must be there) and of the conv (none
   may spill);
3. the dense decode-attention kernel is held against its plain PyTorch
   version on the card at the decode shapes of qwen3-4b, qwen2-0.5b,
   zamba2-7b's shared block (hd 112), granite-34b (48 heads over 1 KV
   head) and mistral-large-123b (96 over 8: groups wider than 8 heads),
   f32 and bf16, with mixed kv_len (1, S, and lengths that are no multiple
   of any tile), and timed beside the plain version, PyTorch's
   scaled_dot_product_attention and its bound, with the kernel's ratio to
   each;
3b. the paged kernel likewise, over a shuffled pool of B*NB + 7 pages with
   sentinel table entries past each row's kv_len, its ratios taken to
   gather + SDPA as well; with identity tables (NB*BS == S) it must equal
   the dense kernel bit for bit;
3c. the causal flash-attention kernel is held against its plain version at
   the prefill shapes of qwen3-4b, qwen2-0.5b, zamba2-7b and dbrx-132b (S
   8, 40, 704, 2048), f32 and bf16, each call on the path its dtype picks
   (bf16 the wgmma kernel, f32 the CUDA-core one), and timed beside the
   plain version, PyTorch's scaled_dot_product_attention(is_causal=True)
   and its bound, with its TFLOP/s;
3d. the SSD scan kernel likewise, on y and the final state, at zamba2-7b's
   (B 1 and 4, H 112, P 64, N 64) and mamba2-780m's (H 48, N 128) widths
   for L 1, 3, 255, 256, 700 and 2048, and at the reference tests' edge
   shapes (G > 1), each call on the path ssd_path names (bf16 at these
   widths and more than 8 steps: the chunked tensor-core path; else the
   step path), with the path and the kernel's ratio to its bound printed;
   no PyTorch call computes the scan;
3e. the grouped-matmul kernel of the MoE expert FFN likewise, elementwise
   and normwise, at dbrx-132b's decode shapes (cap 8: gate/up and down) and
   prefill shapes (cap 224 and 40), the reference tests' shapes and ragged
   ones (C 1, 3, 17; D 100; F 72), f32 and bf16, each call on the path its
   shape picks (gmm_path), timed beside the plain version, torch.bmm and
   its bound, with its TFLOP/s;
4. qwen3-4b at its published widths (bf16, random weights from a seed) is
   served: first through the launcher (repro_torch.launch.serve.main), then
   through a ServeEngine with 8 slots and a 1024-token cache answering 16
   requests with prompts of 32-700 tokens.  Every request must finish; over
   that run the decode kernel's launches must equal decode_steps x layers
   and the flash kernel's prefill_calls x layers; one decode step's logits
   must match the same step with the attention swapped for the plain
   version.  The share of requests whose greedy tokens equal the
   one-request oracle (greedy_reference) is reported, not gated: cuBLAS
   may pick other GEMM algorithms at batch 1 and batch 8.  Prefill is
   timed with the flash kernel and with the eager chunked_attention it
   replaced swapped in, interleaved in this one process.
5. the same 16 requests through the paged engine (launcher first, then a
   ServeEngine with 16-token blocks and a worst-case pool of 512): every
   request finishes, the paged kernel launches decode_steps x layers times
   and the dense one never, the flash kernel prefill_calls x layers times,
   and every request's tokens equal phase 4's;
6. paged capacity at the dense cache's memory: 32 slots over the same 512
   blocks answer a 48-request long-tail burst; every request comes back
   once (done, or shed ``oom`` with its partial output), more than 8 are in
   flight at the peak, and the sheds are counted;
7. the router: the launcher with ``--router --paged``, then two paged
   replicas on the one card sharing one copy of the params answer the 16
   requests without faults and again losing replica 1 a few ticks in;
   every request comes back once in both runs, and the loss fails over;
8. the dwsep conv1d kernel is held against its plain PyTorch version on
   the card at the ECG search space's full-width shapes, f32 and bf16, and
   timed beside the plain version, PyTorch's own two-call equivalent
   (depthwise ``F.conv1d``, then a 1x1 ``F.conv1d`` with bias and ReLU)
   and its bound, with its ratio to each and how its input windows are
   copied (conv_path);
9. the ECG path at full width: 1,024 synthetic records of the paper's
   (3750, 2) shape, a fixed 7-layer genome with every conv at 32 channels
   (w8a16i16), ``compile_winner`` (300 AdamW steps at batch 64, BN
   re-estimation, evaluation, compilation), the winner answering the
   validation set in batches of 32 and 256, and two replicas with a crash
   injected at the first dispatch answering the same batches.  Gates: the
   conv kernel's launches equal conv layers x no-grad forward calls; the
   deployment logits equal the plain version's on the card; the replicas'
   classes equal the winner's, with a failover; detection and false-alarm
   rates are finite.  Train steps/s, eval and served records/s, and the
   kernel's and the idle share of a deployment forward are printed;
10. zamba2-7b at its published widths (81 Mamba-2 layers, d_model 3584,
   the shared attention block applied 13 times at hd 112; bf16, random
   weights from a seed): the launcher, then the 16 requests of phase 4
   through a dense ServeEngine (8 slots, 1024-token cache, exact-length
   buckets) and a paged one (16-token blocks, worst-case pool).  Gates:
   every request finishes; SSD launches = 81 x prefill calls, every one on
   the chunked path, flash = 13 x
   prefill calls, decode = 13 x decode steps (dense, then paged); paged
   tokens equal dense tokens; one prefill's first-token logits and one
   decode step's logits equal the same calls with the plain versions
   swapped in; finite logits.  tok/s, the prefill/decode split, kernels a
   decode step and the idle share are printed, one 700-token prefill's
   device busy time, the SSD scans' share of it and its idle share
   (torch.profiler), and both new kernels are
   held against their plain versions and timed at the inputs one prefill
   gave them, the scan normwise (at random init its y is ~1e-5 of the
   mixer's D-skip, so the logits gate cannot see it);
11. mamba2-780m at its published widths (48 layers, d_model 1536, N 128):
   the launcher behind the router, then 8 of the requests through the
   dense engine; SSD launches = 48 x prefill calls, every one on the
   chunked path, the prefill logits gate, that prefill's device busy time
   and the scans' share of it, and the scan normwise at its inputs;
12. dbrx-132b at its published widths (d_model 6144, 48 heads, 16 experts
   of 10752, top-4) cut to 8 of its 40 layers (bf16, random weights from a
   seed): the launcher on the reduced config (--engine --paged), then the
   16 requests of phase 4 through a dense ServeEngine (8 slots, 1024-token
   cache, buckets of 8) and a paged one (16-token blocks, worst-case pool).
   Gates: every request finishes; gmm launches = 3 x 8 x (prefill calls +
   decode steps), flash = 8 x prefill calls, decode = 8 x decode steps
   (dense, then paged); every gmm launch of capacity > 16 (prefill) on the
   wgmma path and every one of capacity <= 16 (decode steps, and a
   32-token prefill) on the decode path; paged tokens equal dense tokens,
   or the pairs
   dropped at capacity in the prefill calls that held a differing request
   explain it (counted by wrapping moe_block from here); the kernel equals
   gmm_ref normwise at one prefill's and one decode step's own inputs; one
   decode step's logits equal the same step with gmm_ref swapped in, over
   the rows whose routing did not flip (flips counted); finite logits.
   tok/s, the prefill/decode split, kernels a decode step, the idle share,
   the gmm kernel's share of a decode step's device time, its per-call
   times at decode and prefill beside torch.bmm and the bound, and the
   peak device memory are printed;
13. HALF's own loop at the search space's full width on phase 9's records:
   EvolutionarySearch (2 generations of 8 children, 4 accepted, 8 initial
   candidates, 60 steps each, two scheduler threads, the host-overlap
   pipeline; SEARCH_CUTS lists the cuts against the paper's run), then
   serve_winner for the low-energy goal behind 2 replicas, answering the
   validation records.  Gates: no phenotype trained twice (candidates
   trained = the dormant-gene cache's entries, no retry), the population
   within its cap, 2 generations each with a front; the conv kernel's
   launches = conv layers x no-grad forwards of every trained candidate
   and of the winner; one bucket of phase 9's phenotype at 4 quant
   settings, trained batched and scalar on the card for 100 steps, gives
   identical expensive objectives and val_loss within 5e-3 (the winner's
   phenotype likewise is reported beside a scalar run on records one ulp
   up); one trained candidate's eval logits equal those with the plain
   conv swapped in; every served record comes back once, with the
   winner's validation rates.  The search's wall time split into host
   work and training, candidates trained a second, batched and scalar
   steps a second, the bucket's idle share and the conv's share of an
   evaluation (torch.profiler) are printed;
14. the last lines are the card (nvidia-smi), a JSON line of every kernel
   with its launches, error and times, and the JSON result line.

TF32 is switched off for matmuls and cuDNN, so that f32 comparisons on the
card mean full f32.
"""
from __future__ import annotations

import json
import math
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
# rounding can land on either side of a tie (2e-2; 3e-2 for the conv, the
# reference's own conv kernel tests' tolerance)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CONV_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# The ECG path's conv shapes at the search space's full width (B, L, C_in,
# K, C_out, stride), and the reference kernel tests' edge shapes.
CONV_SHAPES = [(256, 3750, 2, 7, 32, 1), (256, 3744, 32, 7, 32, 1),
               (256, 1867, 32, 5, 32, 2), (64, 1875, 16, 3, 8, 4),
               (2, 50, 16, 1, 2, 1), (1, 33, 2, 3, 130, 1)]
# Phase 9's genome: dw7s1c32, dw7s1c32, dw5s2c32, dw5s2c32, mp4, dw3s1c32,
# dw3s2c32 (+ gap, fc2), w8a16i16, decimation 16: input (3750, 2).  Op ids
# index the search space's op table (60 convs, channel-major, then the 4
# pools); node i reads node i - 1; the other 8 nodes are dormant.
ECG_GENES = dict(op_genes=(57, 57, 55, 55, 61, 51, 52) + (0,) * 8,
                 conn_genes=tuple(range(15)), out_gene=7, w_bits_gene=1,
                 a_bits_gene=1, i_bits_gene=1, dec_gene=0)
# deployment logits, conv kernel vs plain conv, f32 end to end: the two
# differ only in summation order (~1e-6 relative per layer), carried through
# seven layers; no activation quant on the deployment path, so nothing
# flips.  Elementwise rtol and atol.
ECG_LOGIT_TOL = 1e-4
# Phase 13: HALF's search at the search space's full width (DEFAULT_SPACE:
# convs up to 32 channels, inputs of 3750 or 1875 samples) on phase 9's
# records.  The paper runs 100 generations x 20 children, 8 accepted a
# generation, 16 initial candidates, 300 steps each, on 16,000 records;
# this run cuts the counts to fit its time, not the widths.
SEARCH_CFG = dict(generations=2, children_per_gen=8, n_accept=4,
                  init_population=8, train_steps=60, train_batch=64,
                  n_workers=2, seed=SEED, goal="low_energy",
                  pipeline="host_overlap")
SEARCH_CUTS = ("2 of 100 generations, 8 of 20 children, 4 of 8 accepted, "
               "8 of 16 initial candidates, 60 of 300 steps, 1,024 of "
               "16,000 records")
# the batched-vs-scalar buckets' steps (the search's train_steps, cut to 60
# to keep the phase near 90 s, does not cut them)
BUCKET_STEPS = 100
# batched vs scalar training of one bucket: the reference's own gate
# (tests/test_trainer_batch.py): expensive objectives identical, val_loss
# within 5e-3
BATCH_VAL_LOSS_TOL = 5e-3
# the bucket's four quant settings (w, a, i genes) of one phenotype.  The
# gated bucket is phase 9's full-width phenotype: the batched step sums in
# other orders than the scalar one on the card (batched GEMMs, reductions
# over another shape), and 100 quantized training steps can carry such
# rounding into other weights, as far as two scalar runs whose records
# differ by one f32 ulp drift apart.  On phase 9's phenotype that drift
# stays far inside the gate (PERF.md §6); the winner's phenotype is
# trained the same way and reported beside a scalar run on records one
# ulp up.
# The first setting (w8a16i16) is the candidate held against the plain
# conv: a 16-bit activation quant moves an activation that lands on a
# rounding boundary on one side only by a 16-bit step, which ECG_LOGIT_TOL
# covers.
BUCKET_QUANTS = ((1, 1, 1), (0, 1, 1), (1, 0, 1), (1, 1, 0))
# logits of one full-width decode step, kernel vs plain attention, bf16 end
# to end, as a normwise relative error ||a - b|| / ||b||: bf16 keeps 8
# significant bits (2^-8 relative rounding), and a one-ulp difference in an
# attention output is re-rounded through 36 layers; 2e-2 allows a few ulps
# at the scale of the whole logit vector.  (An elementwise 2e-2 gate failed
# on the card: one logit moved by 0.0625, a bf16 ulp or two at the
# logits' scale.  The same step with PyTorch's own attention swapped in is
# printed beside it for scale.)
LOGIT_TOL = 2e-2
# The same normwise measure for zamba2-7b and mamba2-780m, kernels vs
# plain versions swapped in: first-token logits of one prefill and one
# decode step's logits.  bf16 end to end through 94 mixers (81 Mamba-2
# layers, 13 shared-block applications) where qwen3-4b has 36: a random
# walk of one-ulp flips scales phase 4's 2e-2 by ~sqrt(94 / 36) to ~3e-2,
# and an SSM state carries a flip on to every later position, so 5e-2.
HYBRID_LOGIT_TOL = 5e-2
# SSD scan, kernel vs plain: 1e-4 on y and the f32 state, the reference's
# own tolerance between its chunked scan and the step-by-step recurrence
# (tests/test_kernels.py), which is what the kernel runs; bf16 y 2e-2, one
# output rounding.
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# SSD scan, kernel vs plain, normwise (||got - want|| / ||want|| of y and of
# the state), the gate that holds at any scale.  At the served models'
# random init the scan's y is ~1e-5 of the mixer's D-skip (dt 1e-3..0.1,
# conv weights +-1/sqrt(K C)), so on the main path's inputs an elementwise
# atol would pass a kernel that wrote zeros; there only this gate runs.
# f32 1e-4, SSD_TOL's reference tolerance taken normwise: y and the state
# are sums of products of mixed sign, summed in another order on each side,
# and a reordering loses ~2^-24 * sqrt(terms) of the terms' magnitude,
# a share of |y| that grows where they cancel (1.12e-5 of ||y|| at L 1
# f32 on an H100 80GB HBM3); bf16 y 1e-2: one output rounding is at most
# 2^-9 relative, and a tie rounded the other way moves one element by a
# ulp (2^-8).
SSD_NORM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# (B, L, H, P, G, N, chunk) of phase 3d: zamba2-7b and mamba2-780m at full
# width, and the reference kernel tests' edge shapes (timed: full width)
SSD_CASES = ([(b, length, 112, 64, 1, 64, 256) for b in (1, 4)
              for length in (1, 3, 255, 256, 700, 2048)]
             + [(1, length, 48, 64, 1, 128, 256)
                for length in (1, 3, 255, 256, 700, 2048)])
SSD_EDGE_CASES = [(2, 64, 4, 16, 1, 16, 16), (1, 128, 8, 32, 2, 32, 32),
                  (2, 96, 6, 8, 3, 8, 24)]
# Grouped matmul, kernel vs plain: the reference's own tolerances
# (tests/test_kernels.py), elementwise rtol = atol: f32 1e-4 (f32 sums in
# another order), bf16 5e-2 (the one output rounding lands on either side).
# Phase 3e scales w by 1/sqrt(D), so outputs are O(1).
GMM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# The same normwise, ||got - want|| / ||want||, which also holds at the
# main path's inputs: f32 1e-4; bf16 1e-2 (one output rounding is at most
# 2^-9 relative, and a tie rounded the other way moves an element by one
# ulp, 2^-8).
GMM_NORM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# (E, C, D, F) of phase 3e: dbrx-132b's decode gate/up and down at cap 8
# (8 slots) and its prefill gate/up at cap 224 (a 704-token bucket) and 40
# (128 tokens), timed; the reference tests' shapes and ragged ones, untimed
GMM_CASES = [(16, 8, 6144, 10752), (16, 8, 10752, 6144),
             (16, 224, 6144, 10752), (16, 40, 6144, 10752)]
GMM_EDGE_CASES = [(4, 32, 64, 48), (8, 16, 128, 64), (2, 64, 32, 32),
                  (3, 1, 100, 72), (2, 3, 100, 72), (2, 17, 100, 72)]
# Phase 12 serves dbrx-132b at its published widths cut to 8 of its 40
# layers: 27.31 B params, 54.6 GB in bf16, where 10 layers (68 GB) would
# leave too little of the 80 GB card for the caches, the prefill buffers
# and the plain version's f32 copy of one expert matrix (4.2 GB).
MOE_LAYERS = 8
# Logits of one dbrx-132b decode step, gmm kernel vs gmm_ref swapped in,
# normwise over the active rows whose routing agrees in every layer: bf16
# through 8 layers, where phase 4's 2e-2 covers 36.  Router logits are bf16
# before the softmax, so one ulp in a hidden state can swap the experts at
# the top-4 boundary; a swapped row takes another expert's output, a
# discontinuity no tolerance covers, so such rows are counted and printed,
# not gated, and at most half the active rows may flip.  The kernel's own
# check is at its inputs (GMM_NORM_TOL).
MOE_LOGIT_TOL = 2e-2
# (H, KVH, hd) of the served models' attention (phases 3-3c), and the
# prompt lengths of phase 3c
ATTN_SHAPES = {"qwen3-4b": (32, 8, 128), "qwen2-0.5b": (14, 2, 64),
               "zamba2-7b": (32, 32, 112)}
# phases 3 and 3b also take the GQA groups wider than 8 heads of the two
# dense configs still to port (src/repro/configs/): granite-34b (MQA, 48
# heads over 1) and mistral-large-123b (96 over 8); phase 3c also takes
# dbrx-132b's prefill attention (phase 12)
DECODE_SHAPES = {**ATTN_SHAPES, "granite-34b": (48, 1, 128),
                 "mistral-large-123b": (96, 8, 128)}
FLASH_SHAPES = {**ATTN_SHAPES, "dbrx-132b": (48, 8, 128)}
FLASH_LENGTHS = (8, 40, 704, 2048)


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


def bound_ms(q, kvh, valid, extra_bytes: int = 0) -> tuple:
    """Least time for one decode attention call: each input byte read once
    (K/V only at the ``valid[b]`` positions each row attends to, plus
    ``extra_bytes``), the output written once; 4*H*hd flops per valid
    position (q.k and p.v)."""
    b, h, hd = q.shape
    item = q.element_size()
    n_valid = int(valid.sum())
    nbytes = (2 * q.numel() * item + 2 * n_valid * kvh * hd * item
              + valid.numel() * 4 + extra_bytes)
    flops = 4 * h * hd * n_valid
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(q, k, kv_len) -> tuple:
    """The dense kernel's bound: k (B, S, KVH, hd), kv_len clamped to S."""
    return bound_ms(q, k.shape[2], kv_len.clamp(max=k.shape[1]))


def paged_bound_ms(q, k_pages, tables, kv_len) -> tuple:
    """The paged kernel's bound: kv_len clamped to NB*BS, plus the table
    entries those positions need (4 bytes each)."""
    bs = k_pages.shape[1]
    valid = kv_len.clamp(max=tables.shape[1] * bs)
    return bound_ms(q, k_pages.shape[2], valid,
                    4 * int(((valid + bs - 1) // bs).sum()))


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
    b, s = 8, 1024
    lens = [1, s, 37, 129, 400, 700, 1000, 255]
    for model, (h, kvh, hd) in DECODE_SHAPES.items():
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
                f"launch cost {host_ms:.4f} ms; "
                + ratios(ms, sdpa=lib_ms, plain=plain_ms, bound=bound))
            del sets


def paged_case(torch, lens, nb, bs, kvh, rep, hd, dtype, gen, n_pages):
    """A pool of ``n_pages`` pages shared out across rows by a seeded
    permutation; table entries past each row's kv_len hold the sentinel
    ``n_pages``."""
    b = len(lens)
    q = torch.randn(b, kvh * rep, hd, generator=gen, device="cuda",
                    dtype=dtype)
    kp = torch.randn(n_pages, bs, kvh, hd, generator=gen, device="cuda",
                     dtype=dtype)
    vp = torch.randn(n_pages, bs, kvh, hd, generator=gen, device="cuda",
                     dtype=dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    tables = torch.full((b, nb), n_pages, dtype=torch.int32, device="cuda")
    for row, n in enumerate(lens):
        used = min(-(-n // bs), nb)
        tables[row, :used] = perm[row * nb: row * nb + used].to(torch.int32)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, kv_len


def gather_call(k_pages, v_pages, tables):
    """The gather half of the two-call PyTorch yardstick (gather, then
    SDPA on the dense view)."""
    from repro_torch.kernels.decode_attention import gather_paged_kv
    return gather_paged_kv(k_pages, v_pages, tables)


def phase_paged_kernels(torch) -> None:
    """Paged kernel vs plain version at the decode shapes of both served
    models, and vs the dense kernel on identity tables (bit for bit)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    b, nb, bs = 8, 64, 16
    s = nb * bs
    lens = [1, s, 37, 129, 400, 700, 1000, 255]
    for model, (h, kvh, hd) in DECODE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            n_pages = b * nb + 7
            per = 2 * n_pages * bs * kvh * hd * dtype.itemsize
            n_sets = max(2, -(-200_000_000 // per))
            sets = [paged_case(torch, lens, nb, bs, kvh, h // kvh, hd, dtype,
                               gen, n_pages) for _ in range(n_sets)]
            got = paged_decode_attention(*sets[0])
            want = paged_decode_attention_ref(*sets[0])
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(),
                                  rtol=TOL[name], atol=TOL[name]):
                raise RuntimeError(f"paged_decode_attention {model} {name}: "
                                   f"kernel disagrees with plain, max err "
                                   f"{err}")
            # identity tables: the dense kernel's arithmetic, bit for bit
            q, k, v, kv_len = (sets[0][0],
                               torch.randn(b, s, kvh, hd, generator=gen,
                                           device="cuda", dtype=dtype),
                               torch.randn(b, s, kvh, hd, generator=gen,
                                           device="cuda", dtype=dtype),
                               sets[0][4])
            ident = torch.arange(b * nb, dtype=torch.int32,
                                 device="cuda").reshape(b, nb)
            paged = paged_decode_attention(
                q, k.reshape(b * nb, bs, kvh, hd),
                v.reshape(b * nb, bs, kvh, hd), ident, kv_len)
            if not torch.equal(paged, decode_attention(q, k, v, kv_len)):
                raise RuntimeError(f"paged_decode_attention {model} {name}: "
                                   f"identity tables differ from the dense "
                                   f"kernel")
            ms = time_ms(paged_decode_attention, sets)
            plain_ms = time_ms(paged_decode_attention_ref, sets)
            gather_ms = time_ms(gather_call, [x[1:4] for x in sets])
            dense_sets = [(x[0], *gather_call(*x[1:4]), x[4])
                          for x in sets]
            lib_ms = time_ms(sdpa_call, dense_sets)
            host_ms = eager_ms(paged_decode_attention, sets)
            bound, by = paged_bound_ms(sets[0][0], sets[0][1], sets[0][3],
                                       sets[0][4])
            log(f"[kernel] paged_decode_attention {model} {name} B={b} "
                f"NB={nb} BS={bs} P={n_pages} H={h} KVH={kvh} hd={hd} "
                f"kv_len={lens}: max_abs_err={err:.3g} (tol {TOL[name]}), "
                f"identity tables == dense kernel bit for bit; "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"gather_ms={gather_ms:.4f} + sdpa_ms(gathered)={lib_ms:.4f}"
                f" bound_ms={bound:.4f} ({by}); eager call with host launch "
                f"cost {host_ms:.4f} ms; "
                + ratios(ms, gather_sdpa=gather_ms + lib_ms, sdpa=lib_ms,
                         plain=plain_ms, bound=bound))
            del sets, dense_sets


def load_model(torch, device: str, reduced: bool, arch: str = "qwen3-4b",
               n_layers: int = 0):
    """``arch`` (published widths, cut to ``n_layers`` where given, or the
    reduced config) with random weights from SEED on ``device``."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.registry import build_model
    cfg = (reduced_config if reduced else get_config)(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, bundle, params


def _tensors(tree):
    """Every tensor of a param tree (dicts and lists)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def burst_requests(cfg, max_new: int = 16, lengths=(32, 700)):
    """The 16 requests of phases 4, 5, 7 and 10 (prompts of 32-700 tokens,
    a seeded order), made anew on every call."""
    import numpy as np

    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(SEED)
    prompt_lens = [int(n) for n in
                   rng.permutation(np.linspace(*lengths, 16).astype(int))]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lens]
    return [ServeRequest(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]


def _wrappers() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from repro_torch.kernels.conv1d import dwsep_conv1d
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.ssd import ssd_scan
    return {"decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "dwsep_conv1d": dwsep_conv1d,
            "flash_attention": flash_attention,
            "ssd_scan": ssd_scan,
            "moe_gmm": gmm}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)


def read_counts() -> dict:
    """Each kernel's launches since reset_counts, by name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_paths(name: str) -> dict:
    """One kernel's launches since reset_counts by the path its entry
    point took (flash_attention, moe_gmm)."""
    return dict(_wrappers()[name].launches_by_path)


def check_launches(counts: dict, want: dict) -> None:
    """Raise unless each named kernel launched the wanted number of times
    (``counts`` from read_counts)."""
    bad = {name: (counts[name], n) for name, n in want.items()
           if counts[name] != n}
    if bad:
        raise RuntimeError("kernel launches (got, want): " + ", ".join(
            f"{name} launched {got} times, want {n}"
            for name, (got, n) in bad.items()))


def split_run(torch, engine, bundle_fields, reqs) -> dict:
    """Run ``reqs`` once more through an engine like ``engine`` whose
    prefill and decode calls are each synchronised and timed, to split the
    wall time between them."""
    import dataclasses

    from repro_torch.serve import ServeEngine
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

    bundle = engine.bundle
    fields = {f: timed(kind, getattr(bundle, f))
              for f, kind in bundle_fields.items()}
    ServeEngine(dataclasses.replace(bundle, **fields), engine.params,
                engine.cfg, device=engine.device).run(reqs)
    log("[serve] split: " + ", ".join(
        f"{k} {n} calls {t:.3f}s ({1e3 * t / max(n, 1):.2f} ms/call)"
        for k, (n, t) in split.items()))
    return split


def prefill_ab(torch, engine, cfg, reqs) -> dict:
    """Prefill ms a call with the flash kernel, and with the eager
    ``chunked_attention`` that prefill ran before it swapped in for the
    flash op: ``reqs()`` through ``split_run`` four times in one process,
    flash, chunked, chunked, flash, so that both see the same host."""
    import repro_torch.models.attention as attention_mod

    def chunked(q, k, v):
        return attention_mod.chunked_attention(q, k, v, causal=True,
                                               chunk=cfg.attn_chunk)
    fields = {"prefill_slotted": "prefill", "decode_slotted": "decode"}
    ms = {"flash": [], "chunked": []}
    for which in ("flash", "chunked", "chunked", "flash"):
        swaps = ([] if which == "flash"
                 else [(attention_mod, "flash_attention", chunked)])
        n, t = swapped(swaps, split_run, torch, engine, fields,
                       reqs())["prefill"]
        ms[which].append(1e3 * t / max(n, 1))
    log(f"[serve] prefill A/B in this process, ms a call (flash, chunked, "
        f"chunked, flash): flash {ms['flash'][0]:.2f} / "
        f"{ms['flash'][1]:.2f}, chunked_attention {ms['chunked'][0]:.2f} / "
        f"{ms['chunked'][1]:.2f}")
    return ms


def mid_run_batch(torch, engine, reqs, device, steps: int = 6) -> dict:
    """``engine`` reset and driven through ``reqs`` to its ``steps``-th
    decode step (a paged engine's tables refreshed, as a tick does before
    it decodes); returns the next step's batch, {"tokens", "active"}."""
    engine.reset()
    for r in reqs:
        engine.submit(r)
    while engine.decode_steps < steps:
        engine.tick(float(engine.decode_steps))
    if engine.paged:
        engine._refresh_tables()
    return {"tokens": torch.as_tensor(engine.last_tok[:, None],
                                      device=device),
            "active": torch.tensor([r is not None for r in engine.active],
                                   device=device)}


def profile_decode(torch, tag, decode, params, state, batch, step_ms):
    """Where three decode steps' device time goes (torch.profiler, CUPTI):
    device busy from the kernels (and copies) the profiler saw on the card,
    idle share against ``step_ms``, the unprofiled step of a split run.
    Returns (busy ms a step, {kernel name: (launches, us) over the three
    steps}), or None where the profiler saw no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    _, state = decode(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            _, state = decode(params, state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del state
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"{tag} the profiler recorded no device kernels: device busy "
            f"and idle share not measured")
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 3e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    log(f"{tag} decode step: device busy {busy_ms:.3f} ms/step over "
        f"{len(kernels) // 3} kernels/step; unprofiled step {step_ms:.3f} ms "
        f"-> device idle share {1 - busy_ms / step_ms:.3f} (wall under the "
        f"profiler {wall_us / 3e3:.3f} ms/step)")
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:8]:
        log(f"{tag}   {t / 3e3:8.4f} ms/step {n // 3:5d}/step  {name[:90]}")
    return busy_ms, by_name


def phase_serve(torch, device: str = "cuda", reduced: bool = False):
    """Full-width qwen3-4b through the launcher and the engine (``device``
    and ``reduced`` let the flow be rehearsed on the CPU at toy size)."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import EngineConfig, ServeEngine, greedy_reference

    log(f"[serve] launcher: repro_torch.launch.serve.main --arch qwen3-4b "
        f"{'--reduced' if reduced else '--no-reduced'} --engine")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", "qwen3-4b",
                       "--reduced" if reduced else "--no-reduced", "--engine",
                       "--device", device, "--seed", str(SEED)])
    log(f"[serve] launcher done in {time.perf_counter() - t0:.1f}s")

    model = load_model(torch, device, reduced)
    cfg, bundle, params = model
    slots, cache_len, max_new = 8, 1024, 16
    prompt_lens = [len(r.prompt) for r in burst_requests(cfg)]

    engine = ServeEngine(bundle, params, EngineConfig(
        slots=slots, cache_len=cache_len, pad_to=8, max_prefill_batch=8),
        device=device)
    engine.run(burst_requests(cfg))          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    done = engine.run(burst_requests(cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["decode_attention"]
    stats = engine.stats()
    if len(done) != 16 or not all(r.done and len(r.out) == max_new
                                  for r in done):
        raise RuntimeError("not every request finished with its tokens")
    check_launches(counts, {
        "decode_attention": stats["decode_steps"] * cfg.n_layers,
        "paged_decode_attention": 0,
        "flash_attention": stats["prefill_calls"] * cfg.n_layers})
    tokens = sum(len(r.out) for r in done)

    split = split_run(torch, engine, {"prefill_slotted": "prefill",
                                      "decode_slotted": "decode"},
                      burst_requests(cfg))
    log(f"[serve] engine: {len(done)} requests, prompts {sorted(prompt_lens)}"
        f", max_new {max_new}, slots {slots}, cache_len {cache_len}: "
        f"{tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s; "
        f"stats {stats}; decode_attention launches {launches} "
        f"(= {stats['decode_steps']} x {cfg.n_layers}), flash_attention "
        f"{counts['flash_attention']} (= {stats['prefill_calls']} x "
        f"{cfg.n_layers})")
    prefill_ab(torch, engine, cfg, lambda: burst_requests(cfg))

    # one mid-run decode step, kernel vs plain attention, same state
    batch = mid_run_batch(torch, engine, burst_requests(cfg), device)
    active = batch["active"]
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

    step_ms = 1e3 * split["decode"][1] / max(split["decode"][0], 1)
    profile_decode(torch, "[profile]", bundle.decode_slotted, params,
                   {k: v.clone() for k, v in snap.items()}, batch, step_ms)

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
    return launches, path, {"model": model, "tokens": {r.rid: r.out
                                                       for r in done}}


def phase_paged_serve(torch, model, dense_tokens, device: str = "cuda",
                      reduced: bool = False):
    """Phase 4's requests through the paged engine: launcher, then engine;
    tokens must equal phase 4's dense engine's, request for request."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        gather_paged_kv,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import EngineConfig, ServeEngine

    log(f"[paged] launcher: repro_torch.launch.serve.main --arch qwen3-4b "
        f"{'--reduced' if reduced else '--no-reduced'} --engine --paged")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", "qwen3-4b",
                       "--reduced" if reduced else "--no-reduced", "--engine",
                       "--paged", "--device", device, "--seed", str(SEED)])
    log(f"[paged] launcher done in {time.perf_counter() - t0:.1f}s")

    cfg, bundle, params = model
    slots, cache_len, max_new = 8, 1024, 16
    engine = ServeEngine(bundle, params, EngineConfig(
        slots=slots, cache_len=cache_len, pad_to=8, max_prefill_batch=8,
        paged=True, block_size=16), device=device)
    engine.run(burst_requests(cfg))              # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    done = engine.run(burst_requests(cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["paged_decode_attention"]
    stats = engine.stats()
    if len(done) != 16 or not all(r.done and len(r.out) == max_new
                                  and not r.oom for r in done):
        raise RuntimeError("paged: not every request finished with its "
                           "tokens")
    check_launches(counts, {
        "paged_decode_attention": stats["decode_steps"] * cfg.n_layers,
        "decode_attention": 0,
        "flash_attention": stats["prefill_calls"] * cfg.n_layers})
    same = sum(r.out == dense_tokens[r.rid] for r in done)
    if same != len(done):
        raise RuntimeError(f"paged engine tokens equal the dense engine's "
                           f"for {same}/{len(done)} requests, want all")
    tokens = sum(len(r.out) for r in done)
    split = split_run(torch, engine, {"prefill_paged": "prefill",
                                      "decode_paged": "decode"},
                      burst_requests(cfg))
    log(f"[paged] engine: {len(done)} requests, max_new {max_new}, slots "
        f"{slots}, cache_len {cache_len}, block_size 16: {tokens} tokens in "
        f"{wall:.3f}s = {tokens / wall:.1f} tok/s; stats {stats}; "
        f"paged_decode_attention launches {launches} (= "
        f"{stats['decode_steps']} x {cfg.n_layers}), dense kernel 0, "
        f"flash_attention {counts['flash_attention']} (= "
        f"{stats['prefill_calls']} x {cfg.n_layers}); tokens equal to the "
        f"dense engine's for {same}/{len(done)} requests")

    # the kernel at the main path's own inputs: a mid-run step's pools,
    # one pair per layer (distinct memory per layer, as in a forward pass)
    batch = mid_run_batch(torch, engine, burst_requests(cfg), device)
    cache = engine.cache
    kv_len = cache["lens"] + 1
    tables = cache["tables"]
    profile_decode(torch, "[paged-profile]", bundle.decode_paged, params,
                   {k: v.clone() for k, v in cache.items()}, batch,
                   1e3 * split["decode"][1] / max(split["decode"][0], 1))
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn(slots, cfg.n_heads, cfg.resolved_head_dim,
                    generator=gen, device=device, dtype=cache["k"].dtype)
    sets = [(q, cache["k"][i], cache["v"][i], tables, kv_len)
            for i in range(cfg.n_layers)]
    got = paged_decode_attention(*sets[0])
    ref = paged_decode_attention_ref(*sets[0])
    err = float((got.float() - ref.float()).abs().max())
    if not torch.allclose(got.float(), ref.float(), rtol=TOL["bfloat16"],
                          atol=TOL["bfloat16"]):
        raise RuntimeError(f"paged kernel vs plain at the main path's "
                           f"inputs: max err {err}")
    bound, by = paged_bound_ms(q, cache["k"][0], tables, kv_len)
    dense_sets = [(q, *gather_paged_kv(*x[1:4]), kv_len) for x in sets]
    path = dict(err=err, ms=time_ms(paged_decode_attention, sets),
                plain_ms=time_ms(paged_decode_attention_ref, sets),
                gather_ms=time_ms(gather_call, [x[1:4] for x in sets]),
                library_ms=time_ms(sdpa_call, dense_sets),
                dense_ms=time_ms(decode_attention, dense_sets),
                bound_ms=bound, bound_by=by, kv_len=kv_len.tolist(),
                blocks_used=engine.pool.used,
                host_ms=eager_ms(paged_decode_attention, sets))
    log(f"[kernel] paged_decode_attention at the main path's step "
        f"{engine.decode_steps} (B={slots} NB={tables.shape[1]} BS=16 "
        f"P={cache['k'].shape[1]} H={cfg.n_heads} KVH={cfg.n_kv_heads} "
        f"hd={cfg.resolved_head_dim} {cfg.dtype}, kv_len {path['kv_len']}, "
        f"{path['blocks_used']} blocks in use): max_abs_err={err:.3g} "
        f"ms={path['ms']:.4f} plain_ms={path['plain_ms']:.4f} "
        f"gather_ms={path['gather_ms']:.4f} + sdpa_ms(gathered)="
        f"{path['library_ms']:.4f} (two calls); dense kernel on the "
        f"gathered view {path['dense_ms']:.4f} ms; bound_ms={bound:.4f} "
        f"({by}); eager call with host launch cost {path['host_ms']:.4f} "
        f"ms; {cfg.n_layers} launches per decode step")
    del sets, dense_sets, cache
    engine.reset()
    return launches, path


def phase_capacity(torch, model, device: str = "cuda",
                   n_blocks: int = 512, cache_len: int = 1024,
                   max_prompt: int = 1008, median_prompt: int = 128):
    """Paged capacity at the dense cache's memory: 32 slots share phase
    4's 8 x 1024 positions (512 blocks of 16) on a long-tail burst."""
    from repro_torch.serve import EngineConfig, ServeEngine, longtail_workload
    cfg, bundle, params = model
    slots = 32
    reqs = longtail_workload(48, vocab_size=cfg.vocab_size, rate_per_s=0.0,
                             median_prompt=median_prompt, sigma=0.8,
                             max_prompt=max_prompt, out_lens=(16, 32),
                             seed=0)
    engine = ServeEngine(bundle, params, EngineConfig(
        slots=slots, cache_len=cache_len, pad_to=8, max_prefill_batch=8,
        paged=True, block_size=16, n_blocks=n_blocks), device=device)
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    if sorted(r.rid for r in done) != list(range(len(reqs))):
        raise RuntimeError("capacity: not every request came back once")
    oom = [r for r in done if r.oom]
    if not all(r.done and (r.oom or len(r.out) == r.max_new) for r in done):
        raise RuntimeError("capacity: a request neither finished nor shed")
    if stats["shed_blocks"] != len(oom):
        raise RuntimeError(f"capacity: shed_blocks {stats['shed_blocks']} "
                           f"!= {len(oom)} requests flagged oom")
    if not stats["peak_concurrency"] > 8:
        raise RuntimeError(f"capacity: peak concurrency "
                           f"{stats['peak_concurrency']}, want > 8")
    tokens = sum(len(r.out) for r in done)
    kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim
                * torch.finfo(getattr(torch, cfg.dtype)).bits // 8)
    log(f"[capacity] {len(reqs)} long-tail requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)}, median "
        f"{sorted(len(r.prompt) for r in reqs)[len(reqs) // 2]}), {slots} "
        f"slots over {n_blocks} blocks x 16 = {n_blocks * 16} positions "
        f"({n_blocks * 16 * kv_bytes / 1e9:.3f} GB of K/V, {kv_bytes} B a "
        f"position): peak concurrency {stats['peak_concurrency']}, peak "
        f"blocks used {stats['peak_blocks_used']}, shed {len(oom)}; "
        f"{tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s (first "
        f"run at these shapes); stats {stats}")
    return stats


def phase_router(torch, model, device: str = "cuda", reduced: bool = False):
    """Two paged replicas on one card, one copy of the params: a clean run
    and a run that loses replica 1 a few ticks in."""
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import EngineConfig, ReplicaRouter, RouterConfig

    log(f"[router] launcher: repro_torch.launch.serve.main --arch qwen3-4b "
        f"{'--reduced' if reduced else '--no-reduced'} --router --paged")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", "qwen3-4b",
                       "--reduced" if reduced else "--no-reduced", "--router",
                       "--paged", "--device", device, "--seed", str(SEED)])
    log(f"[router] launcher done in {time.perf_counter() - t0:.1f}s")

    cfg, bundle, params = model
    ecfg = EngineConfig(slots=8, cache_len=1024, pad_to=8,
                        max_prefill_batch=8, paged=True, block_size=16)
    outs = []
    for lose in (False, True):
        plan = FaultPlan([FaultSpec(
            site="serve.replica", kind="device_loss",
            when=lambda c: c["replica"] == 1 and c["tick"] == 4)]) \
            if lose else None
        router = ReplicaRouter(bundle, params, RouterConfig(
            replicas=2, engine=ecfg), faults=plan, devices=[device])
        if not all(rep.engine.params["embed"] is params["embed"]
                   for rep in router.replicas):
            raise RuntimeError("router: replicas hold copies of the params")
        t0 = time.perf_counter()
        done = router.run(burst_requests(cfg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = router.stats
        if [r.rid for r in done] != list(range(16)) or not all(
                r.done and not r.rejected for r in done):
            raise RuntimeError(f"router ({'replica loss' if lose else 'no '
                               'faults'}): not every request came back once "
                               f"and done")
        if lose and (s["failovers"] < 1 or s["quarantined"] != [1]):
            raise RuntimeError(f"router: replica loss did not fail over "
                               f"({s})")
        tokens = sum(len(r.out) for r in done)
        log(f"[router] {'replica 1 lost at tick 4' if lose else 'no faults'}"
            f": {len(done)} requests, {tokens} tokens in {wall:.3f}s = "
            f"{tokens / wall:.1f} tok/s; stats {s}")
        outs.append({r.rid: r.out for r in done})
    same = sum(outs[0][rid] == outs[1][rid] for rid in outs[0])
    log(f"[router] tokens equal between the clean and the replica-loss run: "
        f"{same}/16 requests (reported, not gated: a failed-over request is "
        f"re-decoded in another batch)")
    return outs


def conv_bound_ms(x, dw, pw, out) -> tuple:
    """Least time for one dwsep conv call: x, dw, pw and b read once, the
    output written once; 2*K*C_in + 2*C_in*C_out + C_out flops per output
    position (depthwise taps, pointwise product, bias)."""
    item = x.element_size()
    b, l_out, c_out = out.shape
    k, c_in = dw.shape
    nbytes = (x.numel() + dw.numel() + pw.numel() + c_out + out.numel()) \
        * item
    flops = b * l_out * (2 * k * c_in + 2 * c_in * c_out + c_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_path(x) -> str:
    """How csrc/dwsep_conv1d.cu brings in the tiles' input windows for x
    (its note): by cp.async in 16- or 4-byte units, the largest on which
    every record's rows start, else by plain loads."""
    rec_bytes = x.shape[1] * x.shape[2] * x.element_size()
    for unit in (16, 4):
        if x.data_ptr() % unit == 0 and rec_bytes % unit == 0:
            return f"cp.async{unit}"
    return "loads"


def conv_depthwise_call(x, dw, stride):
    """PyTorch's depthwise conv on the same channels-last input (the first
    of the two library calls; timed as the yardstick, never used by the
    port)."""
    import torch.nn.functional as F
    return F.conv1d(x.transpose(1, 2), dw.t().unsqueeze(1), stride=stride,
                    groups=x.shape[2])


def conv_pointwise_call(h, pw, b, relu):
    """The second library call: a 1x1 conv with bias, then the ReLU."""
    import torch
    import torch.nn.functional as F
    y = F.conv1d(h, pw.t().unsqueeze(-1), b)
    return torch.relu(y) if relu else y


def conv_library_call(x, dw, pw, b, stride, relu):
    """Both library calls; output channels first (B, C_out, L_out)."""
    return conv_pointwise_call(conv_depthwise_call(x, dw, stride), pw, b,
                               relu)


def conv_case_ms(torch, sets) -> dict:
    """Kernel vs plain on every set (each: x, dw, pw, b, stride, relu),
    then kernel, plain, library and bound times over all sets, per call."""
    from repro_torch.kernels.conv1d import dwsep_conv1d, dwsep_conv1d_ref

    def kernel(x, dw, pw, b, stride, relu):
        return dwsep_conv1d(x, dw, pw, b, stride=stride, relu=relu)

    def plain(x, dw, pw, b, stride, relu):
        return dwsep_conv1d_ref(x, dw, pw, b, stride=stride, relu=relu)

    err, worst, lib_err = 0.0, 0.0, 0.0
    for args in sets:
        got, want = kernel(*args), plain(*args)
        lib = conv_library_call(*args).transpose(1, 2)
        torch.cuda.synchronize()
        tol = CONV_TOL[str(args[0].dtype).split(".")[-1]]
        diff = (got.float() - want.float()).abs()
        # allclose at rtol = atol = tol: |err| <= tol + tol * |plain|
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        if not ratio <= 1.0:
            raise RuntimeError(f"dwsep_conv1d {tuple(args[0].shape)} "
                               f"{tuple(args[2].shape)} K={args[1].shape[0]}"
                               f" s={args[4]} {args[0].dtype}: kernel "
                               f"disagrees with plain, max err "
                               f"{float(diff.max())}, {ratio:.3g} of the "
                               f"tolerance")
        err, worst = max(err, float(diff.max())), max(worst, ratio)
        lib_err = max(lib_err, float((lib.float() - want.float()).abs().max()))
    bounds = [conv_bound_ms(x, dw, pw, torch.empty(
        x.shape[0], (x.shape[1] - dw.shape[0]) // s + 1, pw.shape[1],
        dtype=x.dtype, device="meta")) for x, dw, pw, _, s, _ in sets]
    hs = [(conv_depthwise_call(x, dw, s), pw, b, r)
          for x, dw, pw, b, s, r in sets]
    return dict(err=err, worst=worst, lib_err=lib_err,
                ms=time_ms(kernel, sets),
                plain_ms=time_ms(plain, sets),
                library_ms=time_ms(conv_library_call, sets),
                dw_ms=time_ms(conv_depthwise_call,
                              [(x, dw, s) for x, dw, _, _, s, _ in sets]),
                pw_ms=time_ms(conv_pointwise_call, hs),
                bound_ms=sum(t for t, _ in bounds) / len(bounds),
                bound_by=max(bounds)[1], host_ms=eager_ms(kernel, sets))


def phase_conv_kernels(torch, device: str = "cuda",
                       shapes=CONV_SHAPES) -> None:
    """The conv kernel vs its plain version at the ECG search space's
    full-width shapes, f32 and bf16, with times beside the library's two
    calls and the bound."""
    for b, length, c_in, k, c_out, stride in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=device).manual_seed(SEED)
            # enough copies that the timed loop misses in L2 (at most 64:
            # the small shapes fit in L2 whatever the count)
            per = (b * length * c_in + b * length * c_out // stride) \
                * dtype.itemsize
            n_sets = min(64, max(2, -(-200_000_000 // per)))
            sets = [tuple(torch.randn(shape, generator=gen, device=device,
                                      dtype=dtype)
                          for shape in ((b, length, c_in), (k, c_in),
                                        (c_in, c_out), (c_out,)))
                    + (stride, True) for _ in range(n_sets)]
            r = conv_case_ms(torch, sets)
            name = str(dtype).split(".")[-1]
            rat = ratios(r['ms'], bound=r['bound_ms'], library=r['library_ms'])
            log(f"[kernel] dwsep_conv1d B={b} L={length} C_in={c_in} "
                f"K={k} C_out={c_out} stride={stride} {name}: window copy "
                f"{conv_path(sets[0][0])}, max_abs_err="
                f"{r['err']:.3g}, {r['worst']:.3g} of the tolerance (rtol = "
                f"atol = {CONV_TOL[name]}) ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
                f" (two calls: depthwise F.conv1d {r['dw_ms']:.4f} + 1x1 "
                f"F.conv1d and ReLU {r['pw_ms']:.4f}; library err "
                f"{r['lib_err']:.3g}) bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}; {rat}); eager call with host launch "
                f"cost {r['host_ms']:.4f} ms")
            del sets


def profile_forward(torch, tag, forward, x, forward_ms,
                    what: str = "deployment forward") -> dict:
    """Where three calls of ``forward(x)`` spend device time
    (torch.profiler): device busy, the conv kernel's share of it, and the
    idle share against ``forward_ms``, the unprofiled wall time of one
    call; ``what`` names the call in the log."""
    from torch.profiler import ProfilerActivity, profile
    forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            forward(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"{tag} the profiler recorded no device kernels: kernel share "
            f"and idle share not measured")
        return {}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 3e3
    conv_ms = sum(e.time_range.elapsed_us() for e in kernels
                  if "dwsep_conv1d_kernel" in e.name) / 3e3
    out = dict(busy_ms=busy_ms, conv_ms=conv_ms, kernels=len(kernels) // 3,
               conv_share=conv_ms / busy_ms, idle_share=1 - busy_ms / forward_ms)
    log(f"{tag} {what}: device busy {busy_ms:.4f} ms over "
        f"{out['kernels']} kernels, the conv kernel {conv_ms:.4f} ms = "
        f"{out['conv_share']:.3f} of it; unprofiled call {forward_ms:.4f}"
        f" ms -> device idle share {out['idle_share']:.3f}")
    return out


def phase_ecg(torch, device: str = "cuda", n_samples: int = 1024,
              train_steps: int = 300, train_batch: int = 64,
              batches=(32, 256), timed_steps: int = 50):
    """The ECG path at full width: train, compile and serve a genome whose
    convs are all 32 channels wide on (3750, 2) records.  ``device`` and
    the sizes let the flow be rehearsed on the CPU at toy size."""
    import numpy as np

    import repro_torch.hwlib.layers as layers_mod
    from repro_torch.core import trainer
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.core.genome import Genome, describe
    from repro_torch.data.ecg import make_ecg_dataset, train_val_split
    from repro_torch.kernels.conv1d import dwsep_conv1d, dwsep_conv1d_ref
    from repro_torch.optim import adamw
    from repro_torch.serve import compile_winner, replicate_winner

    t0 = time.perf_counter()
    x, y = make_ecg_dataset(seed=SEED, n_samples=n_samples, decimation=16)
    tr, va = train_val_split(x, y)
    genome = Genome(**ECG_GENES)
    specs = genome.phenotype()
    convs = sum(s.kind == "dwsep_conv" for s in specs)
    log(f"[ecg] data: {x.shape} records ({len(tr[0])} train, {len(va[0])} "
        f"val) in {time.perf_counter() - t0:.1f}s on the host; genome "
        f"{' '.join(s.short() for s in specs)} {genome.quant().short()}, "
        f"{convs} convs\n" + describe(genome))
    x_va, y_va = va

    reset_counts()
    t0 = time.perf_counter()
    winner = compile_winner(genome, tr, va, train_steps=train_steps,
                            train_batch=train_batch, seed=SEED,
                            device=device)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    classes, calls = {}, 0
    for bs in batches:
        classes[bs] = np.concatenate([winner.classify(x_va[i:i + bs])
                                      for i in range(0, len(x_va), bs)])
        calls += -(-len(x_va) // bs)
    plan = FaultPlan([FaultSpec(site="router.dispatch", kind="crash",
                                at=(1,))])
    replicated = replicate_winner(winner, 2, faults=plan)
    rep_classes = {bs: np.concatenate([replicated.classify(x_va[i:i + bs])
                                       for i in range(0, len(x_va), bs)])
                   for bs in batches}
    calls += sum(-(-len(x_va) // bs) for bs in batches)
    torch.cuda.synchronize()
    launches = dwsep_conv1d.launches

    # no-grad forward calls of the run: BN re-estimation (the pre-BN
    # product, then the layer: two launches a conv), one evaluation chunk
    # of 256 records, the accumulator profile, every served batch (a
    # crashed dispatch raises before its forward)
    forwards = 2 + -(-len(x_va) // 256) + 1 + calls
    meta = winner.train_meta
    log(f"[ecg] compile_winner: {train_steps} steps at batch {train_batch}, "
        f"BN re-estimation, evaluation, compilation in {compile_s:.1f}s; "
        f"detection {meta['detection_rate']:.4f} false alarm "
        f"{meta['false_alarm_rate']:.4f} val_loss {meta['val_loss']:.4f}; "
        f"served {len(x_va)} records in batches of {list(batches)} alone "
        f"and behind 2 replicas (stats {replicated.stats}); dwsep_conv1d "
        f"launches {launches} (= {convs} convs x {forwards} no-grad "
        f"forwards)")
    if launches != convs * forwards:
        raise RuntimeError(f"dwsep_conv1d launched {launches} times, want "
                           f"{convs} convs x {forwards} forwards")
    if not all(np.isfinite(meta[k]) for k in ("detection_rate",
                                              "false_alarm_rate",
                                              "val_loss")):
        raise RuntimeError(f"non-finite rates {meta}")
    for bs in batches:
        if not np.array_equal(rep_classes[bs], classes[bs]):
            raise RuntimeError(f"replicated classes differ from the "
                               f"winner's at batch {bs}")
        if bs != batches[0] and not np.array_equal(classes[bs],
                                                   classes[batches[0]]):
            log(f"[ecg] classes at batch {bs} differ from batch "
                f"{batches[0]} in {int((classes[bs] != classes[batches[0]]).sum())}"
                f" records (reported, not gated)")
    if replicated.stats["failovers"] < 1:
        raise RuntimeError(f"the injected crash did not fail over "
                           f"({replicated.stats})")

    # the deployment forward, kernel vs plain conv, on the card
    x256 = x_va[:256]
    logits_k = winner.predict(x256)
    layers_mod.dwsep_conv1d = dwsep_conv1d_ref
    try:
        logits_p = winner.predict(x256)
    finally:
        layers_mod.dwsep_conv1d = dwsep_conv1d
    logit_err = float(np.abs(logits_k - logits_p).max())
    log(f"[ecg] deployment logits ({len(x256)} records), conv kernel vs "
        f"plain: max_abs_err={logit_err:.3g} (tol {ECG_LOGIT_TOL}), |logits|"
        f" max {float(np.abs(logits_p).max()):.3g}; classes equal: "
        f"{bool(np.array_equal(logits_k.argmax(1), logits_p.argmax(1)))}")
    if not np.allclose(logits_k, logits_p, rtol=ECG_LOGIT_TOL,
                       atol=ECG_LOGIT_TOL) or not np.array_equal(
            logits_k.argmax(1), logits_p.argmax(1)):
        raise RuntimeError(f"deployment logits, kernel vs plain conv: max "
                           f"err {logit_err}, or the classes differ")

    def recorded(fn, *args, **kwargs):
        """Run ``fn`` and return the inputs of every conv launch it made."""
        seen = []

        def record(xx, dw, pw, b, *, stride, relu):
            seen.append((xx, dw, pw, b, stride, relu))
            return dwsep_conv1d(xx, dw, pw, b, stride=stride, relu=relu)
        layers_mod.dwsep_conv1d = record
        try:
            fn(*args, **kwargs)
        finally:
            layers_mod.dwsep_conv1d = dwsep_conv1d
        return seen

    # the conv kernel at the main path's inputs: the six convs of one
    # deployment forward at batch 256 (ReLU fused)
    xb = trainer.to_device(tr[0][:256], winner.device)
    seen = recorded(winner._predict, xb)
    path = conv_case_ms(torch, seen)
    for i, args in enumerate(seen):
        one = conv_case_ms(torch, [args])
        log(f"[kernel] dwsep_conv1d deployment conv {i} "
            f"{tuple(args[0].shape)} -> C_out {args[2].shape[1]} K="
            f"{args[1].shape[0]} s={args[4]} window copy "
            f"{conv_path(args[0])}: ms={one['ms']:.4f} plain_ms="
            f"{one['plain_ms']:.4f} library_ms={one['library_ms']:.4f} "
            f"bound_ms={one['bound_ms']:.4f} ({one['bound_by']}; "
            f"{ratios(one['ms'], bound=one['bound_ms'])})")
    log(f"[kernel] dwsep_conv1d over one deployment forward's {len(seen)} "
        f"convs at batch {xb.shape[0]} (per launch, averaged): max_abs_err="
        f"{path['err']:.3g}, {path['worst']:.3g} of the tolerance "
        f"(rtol = atol = {CONV_TOL['float32']}) ms={path['ms']:.4f} plain_ms="
        f"{path['plain_ms']:.4f} library_ms={path['library_ms']:.4f} (two "
        f"calls: {path['dw_ms']:.4f} + {path['pw_ms']:.4f}) bound_ms="
        f"{path['bound_ms']:.4f} ({path['bound_by']}; "
        f"{ratios(path['ms'], bound=path['bound_ms'])}"
        f"); eager call with host launch cost {path['host_ms']:.4f} ms")
    del seen

    # rates: training steps, evaluation, serving at batch 256
    quant = genome.quant()
    x_dev, y_dev, idx_dev, x_calib = trainer.stage_training(
        tr[0], tr[1], SEED, timed_steps + 3, train_batch, winner.device)
    params = trainer.init_candidate(torch.Generator().manual_seed(SEED),
                                    specs, device=winner.device)
    opt = adamw(3e-3, b1=0.9, b2=0.99, weight_decay=1e-4)
    state = opt.init(params)
    rates = {}
    for s in range(timed_steps + 3):
        if s == 3:                       # after warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, state, _ = trainer.train_step_pure(
            params, state, x_dev[idx_dev[s]], y_dev[idx_dev[s]],
            specs=specs, quant=quant, opt=opt)
    torch.cuda.synchronize()
    rates["train_steps_per_s"] = timed_steps / (time.perf_counter() - t0)
    # the launches without ReLU (BN params present) at the main path's
    # inputs: one BN re-estimation on the calibration records and one
    # evaluation, held against the plain version like the deployment convs
    bn_seen = []
    params = trainer.refresh_bn_stats(params, specs, x_calib, quant)
    bn_seen += recorded(trainer.refresh_bn_stats, params, specs, x_calib,
                        quant)
    bn_seen += recorded(trainer.evaluate, params, specs, quant, x_va, y_va,
                        device=winner.device)
    if not bn_seen or any(args[5] for args in bn_seen):
        raise RuntimeError(f"BN re-estimation and evaluation launched "
                           f"{len(bn_seen)} convs, want all without ReLU")
    bn_path = conv_case_ms(torch, bn_seen)
    path["err"] = max(path["err"], bn_path["err"])
    log(f"[kernel] dwsep_conv1d without ReLU over one BN re-estimation "
        f"({len(x_calib)} records) and one evaluation ({len(x_va)} records):"
        f" {len(bn_seen)} launches, max_abs_err={bn_path['err']:.3g}, "
        f"{bn_path['worst']:.3g} of the tolerance (rtol = atol = "
        f"{CONV_TOL['float32']}) ms={bn_path['ms']:.4f} plain_ms="
        f"{bn_path['plain_ms']:.4f} library_ms={bn_path['library_ms']:.4f} "
        f"bound_ms={bn_path['bound_ms']:.4f} ({bn_path['bound_by']})")
    del bn_seen
    t0 = time.perf_counter()
    trainer.evaluate(params, specs, quant, x_va, y_va, device=winner.device)
    rates["eval_records_per_s"] = len(x_va) / (time.perf_counter() - t0)
    x_serve = tr[0][:256]
    winner.predict(x_serve)
    t0 = time.perf_counter()
    for _ in range(5):
        winner.predict(x_serve)
    serve_s = (time.perf_counter() - t0) / 5
    rates["served_records_per_s"] = len(x_serve) / serve_s
    log(f"[ecg] rates: {rates['train_steps_per_s']:.2f} train steps/s (batch"
        f" {train_batch}), {rates['eval_records_per_s']:.1f} eval records/s "
        f"({len(x_va)} records), {rates['served_records_per_s']:.1f} served "
        f"records/s at batch 256 ({1e3 * serve_s:.3f} ms a batch, host "
        f"copies in and out included)")
    t0 = time.perf_counter()
    for _ in range(5):
        winner._predict(xb)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) / 5 * 1e3
    rates.update(profile_forward(torch, "[ecg-profile]", winner._predict, xb,
                                 forward_ms))
    return launches, path, {"winner": winner, "rates": rates,
                            "logit_err": logit_err, "data": (tr, va)}


def flash_flops(q) -> int:
    """4 hd flops per (query, key) pair on or below the diagonal (q.k and
    p.v) for every head."""
    b, s, h, hd = q.shape
    return 4 * hd * h * b * s * (s + 1) // 2


def flash_bound_ms(q, k) -> tuple:
    """Least time for one causal prefill attention call: q, k, v read once
    and the output written once; ``flash_flops`` of work."""
    item = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * item
    flops = flash_flops(q)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_causal_call(q, k, v):
    """PyTorch's own causal attention on the same (B, S, H, hd) inputs
    (timed as the yardstick, never used by the port)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def flash_case_ms(torch, sets) -> dict:
    """Kernel vs plain on every set (q, k, v), then kernel, plain, SDPA and
    bound times per call over all sets, and the kernel's TFLOP/s.  On the
    card each call must take the path its dtype picks (bf16: the
    tensor-core kernel; f32: the CUDA-core one)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    err, lib_err = 0.0, 0.0
    for q, k, v in sets:
        paths = dict(flash_attention.launches_by_path)
        got, want = flash_attention(q, k, v), flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        name = str(q.dtype).split(".")[-1]
        path = "wgmma" if name == "bfloat16" else "fma"
        if q.is_cuda and flash_attention.launches_by_path[path] \
                != paths[path] + 1:
            raise RuntimeError(f"flash_attention {tuple(q.shape)} {name}: "
                               f"the call did not take the {path} path")
        e = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=TOL[name],
                              atol=TOL[name]):
            raise RuntimeError(f"flash_attention {tuple(q.shape)} KVH "
                               f"{k.shape[2]} {name}: kernel disagrees with "
                               f"plain, max err {e}")
        err = max(err, e)
        lib_err = max(lib_err, float((sdpa_causal_call(q, k, v).float()
                                      - want.float()).abs().max()))
    bounds = [flash_bound_ms(q, k) for q, k, _ in sets]
    ms = time_ms(flash_attention, sets)
    flops = sum(flash_flops(q) for q, _, _ in sets) / len(sets)
    return dict(err=err, lib_err=lib_err, ms=ms,
                plain_ms=time_ms(flash_attention_ref, sets),
                library_ms=time_ms(sdpa_causal_call, sets),
                bound_ms=sum(t for t, _ in bounds) / len(bounds),
                bound_by=max(bounds)[1], host_ms=eager_ms(flash_attention,
                                                          sets),
                tflops=flops / ms / 1e9 if ms else 0.0)


def phase_flash_kernels(torch, device: str = "cuda", shapes=FLASH_SHAPES,
                        lengths=FLASH_LENGTHS) -> None:
    """The flash kernel vs its plain version at the prefill shapes of the
    served models, one prompt a call (B 1), f32 and bf16."""
    for model, (h, kvh, hd) in shapes.items():
        for s in lengths:
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=device).manual_seed(SEED)
                per = s * (h + 2 * kvh) * hd * dtype.itemsize
                n_sets = min(64, max(2, -(-200_000_000 // per)))
                sets = [tuple(torch.randn(1, s, n, hd, generator=gen,
                                          device=device, dtype=dtype)
                              for n in (h, kvh, kvh))
                        for _ in range(n_sets)]
                r = flash_case_ms(torch, sets)
                name = str(dtype).split(".")[-1]
                log(f"[kernel] flash_attention {model} {name} B=1 S={s} "
                    f"H={h} KVH={kvh} hd={hd}: max_abs_err={r['err']:.3g} "
                    f"(tol {TOL[name]}) ms={r['ms']:.4f} ({r['tflops']:.1f} "
                    f"TFLOP/s) plain_ms={r['plain_ms']:.4f} sdpa_ms="
                    f"{r['library_ms']:.4f} (sdpa err {r['lib_err']:.3g}) "
                    f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); eager "
                    f"call with host launch cost {r['host_ms']:.4f} ms")
                del sets


def ssd_inputs(torch, b, length, h, p, g, n, dtype, device, gen):
    """x, dt, a_neg, B, C as the Mamba-2 mixer feeds the scan: dt is the
    softplus of N(0, 1/4) plus a dt_bias drawn as the init draws it (dt
    log-uniform in [1e-3, 0.1]), A in [1, 16]."""
    dt_init = torch.exp(torch.rand(h, generator=gen, device=device)
                        * math.log(100.0) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn(b, length, h, generator=gen, device=device)
        + dt_bias)
    return (torch.randn(b, length, h, p, generator=gen, device=device,
                        dtype=dtype), dt,
            -(1.0 + 15.0 * torch.rand(h, generator=gen, device=device)),
            torch.randn(b, length, g, n, generator=gen, device=device,
                        dtype=dtype),
            torch.randn(b, length, g, n, generator=gen, device=device,
                        dtype=dtype))


def ssd_bound_ms(x, b_mat) -> tuple:
    """Least time for one scan: x, dt, B, C read once, y and the f32 state
    written once; 4 N P flops a step and head (the recurrence's state
    update and C . h, the fewest the function needs)."""
    bsz, length, h, p = x.shape
    n = b_mat.shape[3]
    item = x.element_size()
    nbytes = (2 * x.numel() + 2 * b_mat.numel()) * item \
        + bsz * length * h * 4 + h * 4 + bsz * h * n * p * 4
    flops = 4 * bsz * length * h * n * p
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_path_for(dtype, n: int, p: int, length: int) -> str:
    """The path csrc/ssd.cu's entry point takes for x of ``dtype`` (a
    torch dtype or its name) with state size ``n``, head dim ``p`` and
    ``length`` steps on 16-byte aligned tensors (its note): the chunked
    form on the tensor cores for bf16 at N 64 or 128, P a multiple of 64
    and more than 8 steps, the recurrence step by step otherwise."""
    bf16 = str(dtype).split(".")[-1] == "bfloat16"
    return "chunked" if bf16 and n in (64, 128) and p % 64 == 0 \
        and length > 8 else "step"


def ssd_path(x, b_mat, c_mat) -> str:
    """ssd_path_for these inputs, their alignment included (y is a fresh
    allocation, aligned)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, b_mat, c_mat))
    path = ssd_path_for(x.dtype, b_mat.shape[3], x.shape[3], x.shape[1])
    return path if aligned else "step"


def check_ssd_paths(tag, paths: dict, want: str, n: int) -> None:
    """Phases 10-11's path gate: every one of a run's ``n`` scans took the
    path ``want`` (ssd_path_for the model's dtype and widths)."""
    expect = {name: (n if name == want else 0) for name in paths}
    if paths != expect:
        raise RuntimeError(f"{tag} ssd_scan launches by path {paths}, want "
                           f"{expect}")


def ssd_case_ms(torch, sets, chunk: int, timed: bool = True,
                elementwise: bool = True) -> dict:
    """Kernel vs plain (y and state) on every set (x, dt, a_neg, B, C),
    normwise (SSD_NORM_TOL) and, where ``elementwise``, also elementwise
    (SSD_TOL, printed as a share of the tolerance); then kernel, plain and
    bound times per call over all sets.  ``y_over_x`` is the largest
    ||y|| / ||x|| of a set: the scan's size beside the mixer's D-skip at
    D = 1.  On the card each call must take the path ssd_path names;
    ``path`` lists the paths taken."""
    from repro_torch.kernels.ssd import ssd_chunked, ssd_scan

    def kernel(*args):
        return ssd_scan(*args, chunk)

    def plain(*args):
        return ssd_chunked(*args, chunk)

    err, worst, rel, y_over_x = 0.0, 0.0, 0.0, 0.0
    taken = []
    for args in sets:
        path = ssd_path(args[0], args[3], args[4])
        before = dict(ssd_scan.launches_by_path) if args[0].is_cuda else {}
        (y, st), (wy, wst) = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        name = str(args[0].dtype).split(".")[-1]
        if args[0].is_cuda and ssd_scan.launches_by_path[path] \
                != before[path] + 1:
            raise RuntimeError(f"ssd_scan {tuple(args[0].shape)} N="
                               f"{args[3].shape[3]} {name}: the call did not "
                               f"take the {path} path")
        if path not in taken:
            taken.append(path)
        y_over_x = max(y_over_x, float(wy.float().norm()
                                       / args[0].float().norm()))
        for what, got, want, tol, norm_tol in (
                ("y", y, wy, SSD_TOL[name], SSD_NORM_TOL[name]),
                ("state", st, wst, SSD_TOL["float32"],
                 SSD_NORM_TOL["float32"])):
            diff = (got.float() - want.float()).abs()
            r = rel_err(got, want)
            ratio = float((diff / (tol + tol * want.float().abs())).max())
            if not (r <= norm_tol and torch.isfinite(got).all()
                    and (ratio <= 1.0 or not elementwise)):
                raise RuntimeError(
                    f"ssd_scan {tuple(args[0].shape)} G={args[3].shape[2]} "
                    f"N={args[3].shape[3]} {name}: kernel disagrees with "
                    f"plain on {what}: normwise {r:.3g} (tol {norm_tol}), "
                    f"max err {float(diff.max())}, {ratio:.3g} of the "
                    f"elementwise tolerance")
            err, rel = max(err, float(diff.max())), max(rel, r)
            worst = max(worst, ratio)
    out = dict(err=err, worst=worst, rel=rel, y_over_x=y_over_x,
               tol_y=SSD_NORM_TOL[name], path="+".join(taken))
    if timed:
        bounds = [ssd_bound_ms(a[0], a[3]) for a in sets]
        out.update(ms=time_ms(kernel, sets), plain_ms=time_ms(plain, sets),
                   bound_ms=sum(t for t, _ in bounds) / len(bounds),
                   bound_by=max(bounds)[1], host_ms=eager_ms(kernel, sets))
    return out


def phase_ssd_kernels(torch, device: str = "cuda", cases=SSD_CASES,
                      edge_cases=SSD_EDGE_CASES) -> None:
    """The SSD kernel vs its plain version at the served models' widths
    (timed) and the reference tests' edge shapes, f32 and bf16."""
    for case in list(cases) + list(edge_cases):
        b, length, h, p, g, n, chunk = case
        timed = case not in edge_cases
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=device).manual_seed(SEED)
            per = 2 * b * length * h * p * dtype.itemsize
            n_sets = min(16, max(2, -(-200_000_000 // per))) if timed else 1
            sets = [ssd_inputs(torch, b, length, h, p, g, n, dtype, device,
                               gen) for _ in range(n_sets)]
            r = ssd_case_ms(torch, sets, chunk, timed)
            name = str(dtype).split(".")[-1]
            times = (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                     f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; "
                     f"{ratios(r['ms'], bound=r['bound_ms'])}"
                     f"); no PyTorch call computes the scan; eager call with "
                     f"host launch cost {r['host_ms']:.4f} ms") if timed \
                else ""
            log(f"[kernel] ssd_scan B={b} L={length} H={h} P={p} G={g} "
                f"N={n} chunk={chunk} {name} path={r['path']}: "
                f"max_abs_err={r['err']:.3g}, "
                f"{r['worst']:.3g} of the tolerance (y rtol = atol = "
                f"{SSD_TOL[name]}, state {SSD_TOL['float32']}); normwise "
                f"{r['rel']:.3g} (tol y {SSD_NORM_TOL[name]}, state "
                f"{SSD_NORM_TOL['float32']}){times}")
            del sets


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def swapped(mods_and_fns, fn, *args):
    """``fn(*args)`` with module attributes swapped for the duration:
    ``mods_and_fns`` is a list of (module, name, replacement)."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in mods_and_fns]
    for m, n, f in mods_and_fns:
        setattr(m, n, f)
    try:
        return fn(*args)
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def plain_swaps():
    """Every kernel on the hybrid path, swapped for its plain version."""
    import repro_torch.models.attention as attention_mod
    import repro_torch.models.mamba2 as mamba2_mod
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref,
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.ssd import ssd_chunked
    return [(mamba2_mod, "ssd_scan", ssd_chunked),
            (attention_mod, "flash_attention", flash_attention_ref),
            (attention_mod, "decode_attention", decode_attention_ref),
            (attention_mod, "paged_decode_attention",
             paged_decode_attention_ref)]


def prefill_gate(torch, bundle, params, prompt, device, tag):
    """One exact-length prefill of ``prompt`` with the kernels, and again
    with the plain versions swapped in: the first-token logits must be
    finite and agree normwise within HYBRID_LOGIT_TOL.  Returns (relative
    error, the inputs of every SSD and flash launch of the kernel run)."""
    import repro_torch.models.attention as attention_mod
    import repro_torch.models.mamba2 as mamba2_mod
    seen = {"ssd_scan": [], "flash_attention": []}
    ssd, flash = mamba2_mod.ssd_scan, attention_mod.flash_attention

    def rec_ssd(*args):
        seen["ssd_scan"].append(args)
        return ssd(*args)

    def rec_flash(*args):
        seen["flash_attention"].append(args)
        return flash(*args)
    batch = {"tokens": torch.as_tensor(prompt, device=device)[None],
             "lens": torch.tensor([len(prompt)], dtype=torch.int32,
                                  device=device),
             "cache_len": len(prompt)}
    logits_k, _ = swapped([(mamba2_mod, "ssd_scan", rec_ssd),
                           (attention_mod, "flash_attention", rec_flash)],
                          bundle.prefill_slotted, params, batch)
    logits_p, _ = swapped(plain_swaps(), bundle.prefill_slotted, params,
                          batch)
    rel = rel_err(logits_k, logits_p)
    log(f"{tag} prefill of {len(prompt)} tokens: first-token logits "
        f"kernels vs plain: rel_err={rel:.4g} (tol {HYBRID_LOGIT_TOL}), "
        f"argmax equal {bool(logits_k.argmax() == logits_p.argmax())}")
    if not torch.isfinite(logits_k).all() or not rel <= HYBRID_LOGIT_TOL:
        raise RuntimeError(f"{tag} prefill logits, kernels vs plain: "
                           f"relative error {rel} over {HYBRID_LOGIT_TOL}, "
                           f"or not finite")
    return rel, seen


def profile_prefill(torch, tag, bundle, params, prompt, device) -> dict:
    """Where one exact-length prefill's device time goes: the unprofiled
    wall time of a call (two warm-up calls, then three timed), and under
    torch.profiler (CUPTI) over three more calls the device busy time, the
    SSD scan kernels' share of it, and the idle share.  Empty where the
    profiler saw no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    batch = {"tokens": torch.as_tensor(prompt, device=device)[None],
             "lens": torch.tensor([len(prompt)], dtype=torch.int32,
                                  device=device),
             "cache_len": len(prompt)}
    for _ in range(2):
        bundle.prefill_slotted(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        bundle.prefill_slotted(params, batch)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            bundle.prefill_slotted(params, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"{tag} the profiler recorded no device kernels: a prefill's "
            f"device busy and idle share not measured")
        return {}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 3e3
    ssd_ms = sum(e.time_range.elapsed_us() for e in kernels
                 if "ssd_" in e.name) / 3e3
    out = dict(busy_ms=busy_ms, ssd_ms=ssd_ms, kernels=len(kernels) // 3,
               call_ms=call_ms, idle_share=1 - busy_ms / call_ms)
    log(f"{tag} prefill of {len(prompt)} tokens: device busy {busy_ms:.3f} "
        f"ms over {out['kernels']} kernels, the SSD scans {ssd_ms:.3f} ms = "
        f"{ssd_ms / busy_ms:.3f} of it; unprofiled call {call_ms:.3f} ms -> "
        f"device idle share {out['idle_share']:.3f}")
    return out


def engine_run(torch, engine, reqs):
    """Warm-up run, then the measured run with every count reset just
    before it.  Returns (requests, wall s, counts, stats)."""
    engine.run(reqs())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs())
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, read_counts(), engine.stats()


def phase_hybrid(torch, device: str = "cuda", reduced: bool = False,
                 arch: str = "zamba2-7b", cache_len: int = 1024,
                 lengths=(32, 700)):
    """zamba2-7b at full width: launcher, dense engine, paged engine, the
    logits gates, and both new kernels at one prefill's inputs.  The
    keywords let the flow be rehearsed on the CPU at toy size."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.hybrid import _layout
    from repro_torch.serve import EngineConfig, ServeEngine

    size = "--reduced" if reduced else "--no-reduced"
    log(f"[{arch}] launcher: repro_torch.launch.serve.main --arch {arch} "
        f"{size} --engine")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", arch, size, "--engine", "--device", device,
                       "--seed", str(SEED)])
    log(f"[{arch}] launcher done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    cfg, bundle, params = load_model(torch, device, reduced, arch)
    n_groups = _layout(cfg)[0]
    slots, max_new = 8, 16
    # every prefill of the burst is longer than 8 steps
    ssd_want = ssd_path_for(cfg.dtype, cfg.ssm_state, cfg.ssm_head_dim,
                            min(lengths))

    def reqs():
        return burst_requests(cfg, max_new, lengths)
    results = {}
    for paged in (False, True):
        tag = f"[{arch}{' paged' if paged else ''}]"
        engine = ServeEngine(bundle, params, EngineConfig(
            slots=slots, cache_len=cache_len, pad_to=1, max_prefill_batch=8,
            paged=paged, block_size=16), device=device)
        done, wall, counts, stats = engine_run(torch, engine, reqs)
        ssd_paths = read_paths("ssd_scan")
        if len(done) != 16 or not all(r.done and len(r.out) == max_new
                                      and not r.oom for r in done):
            raise RuntimeError(f"{tag} not every request finished with its "
                               f"tokens")
        decode = "paged_decode_attention" if paged else "decode_attention"
        other = "decode_attention" if paged else "paged_decode_attention"
        check_launches(counts, {
            "ssd_scan": stats["prefill_calls"] * cfg.n_layers,
            "flash_attention": stats["prefill_calls"] * n_groups,
            decode: stats["decode_steps"] * n_groups, other: 0})
        check_ssd_paths(tag, ssd_paths, ssd_want,
                        stats["prefill_calls"] * cfg.n_layers)
        tokens = {r.rid: r.out for r in done}
        if paged:
            same = sum(tokens[rid] == results["dense"]["tokens"][rid]
                       for rid in tokens)
            if same != len(done):
                raise RuntimeError(f"{tag} paged engine tokens equal the "
                                   f"dense engine's for {same}/{len(done)} "
                                   f"requests, want all")
        kind = "paged" if paged else "slotted"
        split = split_run(torch, engine, {f"prefill_{kind}": "prefill",
                                          f"decode_{kind}": "decode"},
                          reqs())
        n_tok = sum(len(r.out) for r in done)
        log(f"{tag} engine: {len(done)} requests, max_new {max_new}, slots "
            f"{slots}, cache_len {cache_len}{', block_size 16' if paged else ''}"
            f": {n_tok} tokens in {wall:.3f}s = {n_tok / wall:.1f} tok/s; "
            f"stats {stats}; launches {counts} (ssd = {stats['prefill_calls']}"
            f" x {cfg.n_layers}, all on its {ssd_want} path: {ssd_paths}; "
            f"flash = {stats['prefill_calls']} x "
            f"{n_groups}, {decode} = {stats['decode_steps']} x {n_groups})"
            + (f"; tokens equal to the dense engine's for {same}/16 requests"
               if paged else ""))
        results["paged" if paged else "dense"] = dict(
            tokens=tokens, counts=counts, stats=stats, wall=wall,
            tok_s=n_tok / wall, split=split, ssd_paths=ssd_paths)

        # one mid-run decode step: kernels vs plain versions, same state
        batch = mid_run_batch(torch, engine, reqs(), device)
        active = batch["active"]
        step = bundle.decode_paged if paged else bundle.decode_slotted

        def clone():
            return {k: v.clone() for k, v in engine.cache.items()}
        logits_k, _ = step(params, clone(), batch)
        logits_p, _ = swapped(plain_swaps(), step, params, clone(), batch)
        if not torch.isfinite(logits_k).all():
            raise RuntimeError(f"{tag} non-finite decode-step logits")
        step_rel = rel_err(logits_k[active], logits_p[active])
        agree = float((logits_k[active].argmax(-1)
                       == logits_p[active].argmax(-1)).float().mean())
        log(f"{tag} decode step {engine.decode_steps}: logits kernels vs "
            f"plain: rel_err={step_rel:.4g} (tol {HYBRID_LOGIT_TOL}), "
            f"argmax agreement {agree:.3f}")
        if not step_rel <= HYBRID_LOGIT_TOL:
            raise RuntimeError(f"{tag} decode-step logits, kernels vs plain:"
                               f" relative error {step_rel} over "
                               f"{HYBRID_LOGIT_TOL}")
        step_ms = 1e3 * split["decode"][1] / max(split["decode"][0], 1)
        profile_decode(torch, f"{tag}[profile]", step, params, clone(),
                       batch, step_ms)
        if not paged:
            # the dense decode kernel at hd 112, at this step's caches
            kv_len = engine.cache["lens"] + 1
            gen = torch.Generator(device=device).manual_seed(SEED)
            q = torch.randn(slots, cfg.n_heads, cfg.resolved_head_dim,
                            generator=gen, device=device,
                            dtype=engine.cache["k"].dtype)
            sets = [(q, engine.cache["k"][i], engine.cache["v"][i], kv_len)
                    for i in range(n_groups)]
            got, ref = decode_attention(*sets[0]), decode_attention_ref(
                *sets[0])
            err = float((got.float() - ref.float()).abs().max())
            if not torch.allclose(got.float(), ref.float(),
                                  rtol=TOL["bfloat16"], atol=TOL["bfloat16"]):
                raise RuntimeError(f"{tag} decode kernel vs plain at hd "
                                   f"112: max err {err}")
            bound, by = attention_bound_ms(q, engine.cache["k"][0], kv_len)
            log(f"[kernel] decode_attention at {arch}'s step "
                f"{engine.decode_steps} (B={slots} S={cache_len} H="
                f"{cfg.n_heads} KVH={cfg.n_kv_heads} hd="
                f"{cfg.resolved_head_dim}, kv_len {kv_len.tolist()}): "
                f"max_abs_err={err:.3g} ms={time_ms(decode_attention, sets):.4f}"
                f" plain_ms={time_ms(decode_attention_ref, sets):.4f} "
                f"sdpa_ms={time_ms(sdpa_call, sets):.4f} bound_ms="
                f"{bound:.4f} ({by}); {n_groups} launches per decode step")
            del sets
        engine.reset()
        del engine

    # one prefill's first-token logits, kernels vs plain versions; the
    # kernels at the inputs that prefill gave them
    prompt = max((r.prompt for r in reqs()), key=len)
    pre_rel, seen = prefill_gate(torch, bundle, params, prompt, device,
                                 f"[{arch}]")
    with torch.no_grad():
        pre_prof = profile_prefill(torch, f"[{arch}][profile]", bundle,
                                   params, prompt, device)
    if len(seen["ssd_scan"]) != cfg.n_layers \
            or len(seen["flash_attention"]) != n_groups:
        raise RuntimeError(f"[{arch}] one prefill launched "
                           f"{len(seen['ssd_scan'])} scans and "
                           f"{len(seen['flash_attention'])} flash calls")
    paths = {"ssd_scan": ssd_case_ms(torch, [a[:5] for a in seen["ssd_scan"]],
                                     cfg.ssm_chunk, elementwise=False),
             "flash_attention": flash_case_ms(torch,
                                              seen["flash_attention"])}
    for name, r in paths.items():
        lib = (f"sdpa_ms={r['library_ms']:.4f}" if "library_ms" in r
               else "no PyTorch call computes the scan")
        norm = (f"path {r['path']}, normwise {r['rel']:.3g} (tol y "
                f"{r['tol_y']}, state {SSD_NORM_TOL['float32']}), ||y|| / "
                f"||x|| {r['y_over_x']:.3g} " if "rel" in r else "")
        log(f"[kernel] {name} at one {len(prompt)}-token prefill's "
            f"{len(seen[name])} launches (per launch, averaged): "
            f"max_abs_err={r['err']:.3g} {norm}ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} {lib} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}; {ratios(r['ms'], bound=r['bound_ms'])}); "
            f"eager call with host launch cost {r['host_ms']:.4f} ms")
    del seen
    results.update(paths=paths, prefill_rel=pre_rel, prefill=pre_prof,
                   model=(cfg, bundle, params))
    return results


def phase_mamba(torch, device: str = "cuda", reduced: bool = False,
                arch: str = "mamba2-780m", n_requests: int = 8,
                cache_len: int = 1024, lengths=(32, 700)):
    """mamba2-780m at full width: the launcher behind the router, then a
    short dense-engine run with its launch and prefill-logits gates."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import EngineConfig, ServeEngine

    size = "--reduced" if reduced else "--no-reduced"
    log(f"[{arch}] launcher: repro_torch.launch.serve.main --arch {arch} "
        f"{size} --router --paged")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", arch, size, "--router", "--paged",
                       "--device", device, "--seed", str(SEED)])
    log(f"[{arch}] launcher done in {time.perf_counter() - t0:.1f}s")
    cfg, bundle, params = load_model(torch, device, reduced, arch)

    def reqs():
        return burst_requests(cfg, 16, lengths)[:n_requests]
    engine = ServeEngine(bundle, params, EngineConfig(
        slots=8, cache_len=cache_len, pad_to=1, max_prefill_batch=8),
        device=device)
    done, wall, counts, stats = engine_run(torch, engine, reqs)
    ssd_paths = read_paths("ssd_scan")
    if len(done) != n_requests or not all(r.done and len(r.out) == 16
                                          for r in done):
        raise RuntimeError(f"[{arch}] not every request finished")
    check_launches(counts, {"ssd_scan": stats["prefill_calls"] * cfg.n_layers,
                            "flash_attention": 0, "decode_attention": 0,
                            "paged_decode_attention": 0})
    ssd_want = ssd_path_for(cfg.dtype, cfg.ssm_state, cfg.ssm_head_dim,
                            min(lengths))
    check_ssd_paths(f"[{arch}]", ssd_paths, ssd_want,
                    stats["prefill_calls"] * cfg.n_layers)
    n_tok = sum(len(r.out) for r in done)
    log(f"[{arch}] engine: {len(done)} requests, max_new 16, slots 8, "
        f"cache_len {cache_len}: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tok/s; stats {stats}; ssd_scan launches "
        f"{counts['ssd_scan']} (= {stats['prefill_calls']} x "
        f"{cfg.n_layers}, all on its {ssd_want} path: {ssd_paths}); its "
        f"decode step runs no kernel (no attention), "
        f"so only its prefill has a logits gate")
    prompt = max((r.prompt for r in reqs()), key=len)
    pre_rel, seen = prefill_gate(torch, bundle, params, prompt, device,
                                 f"[{arch}]")
    with torch.no_grad():
        pre_prof = profile_prefill(torch, f"[{arch}][profile]", bundle,
                                   params, prompt, device)
    r = ssd_case_ms(torch, [a[:5] for a in seen["ssd_scan"]], cfg.ssm_chunk,
                    elementwise=False)
    log(f"[kernel] ssd_scan at one {len(prompt)}-token {arch} prefill's "
        f"{len(seen['ssd_scan'])} launches (per launch, averaged): path "
        f"{r['path']}, max_abs_err={r['err']:.3g} normwise {r['rel']:.3g} "
        f"(tol y {r['tol_y']}, state {SSD_NORM_TOL['float32']}), "
        f"||y|| / ||x|| {r['y_over_x']:.3g} ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']}; {ratios(r['ms'], bound=r['bound_ms'])})")
    return dict(counts=counts, stats=stats, tok_s=n_tok / wall,
                prefill_rel=pre_rel, path=r, ssd_paths=ssd_paths,
                prefill=pre_prof)


def gmm_inputs(torch, e, c, d, f, dtype, device, gen):
    """x (E, C, D) ~ N(0, 1) and w (E, D, F) ~ N(0, 1/D), so that every
    output is O(1)."""
    x = torch.randn(e, c, d, generator=gen, device=device).to(dtype)
    w = (torch.randn(e, d, f, generator=gen, device=device)
         / math.sqrt(d)).to(dtype)
    return x, w


def gmm_flops(x, w) -> int:
    """2 E C D F (every capacity row is computed)."""
    e, c, d = x.shape
    return 2 * e * c * d * w.shape[2]


def gmm_path(x, w) -> str:
    """The path csrc/moe_gmm.cu's entry point should take for these
    inputs (its note): f32; bf16 decode at C <= 16; bf16 wgmma where TMA
    takes the strides and pointers; bf16 WMMA elsewhere."""
    c, d, f = x.shape[1], x.shape[2], w.shape[2]
    if x.dtype != w.dtype or str(x.dtype) != "torch.bfloat16":
        return "f32"
    if c <= 16:
        return "decode"
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w))
    return "wgmma" if d % 8 == 0 and f % 8 == 0 and d and aligned \
        else "wmma"


def gmm_bound_ms(x, w) -> tuple:
    """Least time for one grouped matmul: x and w read once, the output
    written once; ``gmm_flops`` of work."""
    e, c, d = x.shape
    f = w.shape[2]
    item = x.element_size()
    nbytes = (x.numel() + w.numel() + e * c * f) * item
    flops = gmm_flops(x, w)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bmm_call(x, w):
    """PyTorch's own batched product on the same inputs (timed as the
    yardstick, never used by the port)."""
    import torch
    return torch.bmm(x, w)


def gmm_case_ms(torch, sets, timed: bool = True) -> dict:
    """Kernel vs plain on every set (x, w), elementwise (GMM_TOL, printed
    as a share of the tolerance) and normwise (GMM_NORM_TOL); then kernel,
    plain, torch.bmm and bound times per call, and the kernel's TFLOP/s.
    On the card each call must take the path ``gmm_path`` names.  The
    plain version is timed over the first three sets only: each of its
    bf16 calls makes an f32 copy of a weight matrix (4.2 GB at dbrx-132b's
    widths)."""
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    err, rel, worst = 0.0, 0.0, 0.0
    for x, w in sets:
        paths = dict(getattr(gmm, "launches_by_path", {}))
        got, want = gmm(x, w), gmm_ref(x, w)
        torch.cuda.synchronize()
        path = gmm_path(x, w)
        if x.is_cuda and gmm.launches_by_path[path] != paths[path] + 1:
            raise RuntimeError(f"gmm {tuple(x.shape)} @ {tuple(w.shape)}: "
                               f"the call did not take the {path} path")
        name = str(x.dtype).split(".")[-1]
        tol = GMM_TOL[name]
        diff = (got.float() - want.float()).abs()
        r = rel_err(got, want)
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        if not (torch.isfinite(got).all() and r <= GMM_NORM_TOL[name]
                and ratio <= 1.0):
            raise RuntimeError(
                f"gmm {tuple(x.shape)} @ {tuple(w.shape)} {name}: kernel "
                f"disagrees with plain: normwise {r:.3g} (tol "
                f"{GMM_NORM_TOL[name]}), max err {float(diff.max())}, "
                f"{ratio:.3g} of the elementwise tolerance")
        err, rel = max(err, float(diff.max())), max(rel, r)
        worst = max(worst, ratio)
        del got, want, diff
    out = dict(err=err, rel=rel, worst=worst, path=path)
    if timed:
        bounds = [gmm_bound_ms(x, w) for x, w in sets]
        ms = time_ms(gmm, sets)
        flops = sum(gmm_flops(x, w) for x, w in sets) / len(sets)
        out.update(ms=ms, plain_ms=time_ms(gmm_ref, sets[:3]),
                   library_ms=time_ms(bmm_call, sets),
                   bound_ms=sum(t for t, _ in bounds) / len(bounds),
                   bound_by=max(bounds)[1],
                   tflops=flops / ms / 1e9 if ms else 0.0)
        torch.cuda.empty_cache()
    return out


def gmm_times(r) -> str:
    return (f"ms={r['ms']:.4f} ({r['tflops']:.1f} TFLOP/s, {r['path']} "
            f"path) plain_ms={r['plain_ms']:.4f} bmm_ms="
            f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")


def phase_gmm_kernels(torch, device: str = "cuda", cases=GMM_CASES,
                      edge_cases=GMM_EDGE_CASES) -> None:
    """The grouped-matmul kernel vs its plain version at dbrx-132b's
    shapes (timed) and the reference tests' and ragged shapes, f32 and
    bf16."""
    for case in list(cases) + list(edge_cases):
        timed = case not in edge_cases
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=device).manual_seed(SEED)
            sets = [gmm_inputs(torch, *case, dtype, device, gen)]
            r = gmm_case_ms(torch, sets, timed)
            name = str(dtype).split(".")[-1]
            e, c, d, f = case
            log(f"[kernel] moe_gmm E={e} C={c} D={d} F={f} {name}: "
                f"max_abs_err={r['err']:.3g}, {r['worst']:.3g} of the "
                f"tolerance (rtol = atol = {GMM_TOL[name]}); normwise "
                f"{r['rel']:.3g} (tol {GMM_NORM_TOL[name]})"
                + (f" {gmm_times(r)}" if timed else ""))
            del sets
            torch.cuda.empty_cache()


def drop_accounting(torch, engine, reqs, prefill_field: str, caps=None):
    """``reqs`` through an engine like ``engine`` whose prefill records the
    requests each call holds, with ``moe_block`` wrapped to count the
    (token, expert) pairs each call drops at capacity (summed over the
    layers, on the device, read once at the end).  Returns ({rid: pairs
    dropped in the prefill calls that held it}, pairs dropped in decode
    steps, {rid: tokens}); a ``caps`` list gets (prefill?, capacity) of
    every moe_block call.  The program itself counts nothing."""
    import dataclasses

    import repro_torch.models.transformer as transformer_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ServeEngine
    by_prompt = {tuple(r.prompt.tolist()): r.rid for r in reqs}
    current = {"rids": None}
    drops = []
    block = transformer_mod.moe_block

    def counting(p, x, cfg):
        t = x.shape[0] * x.shape[1]
        _, _, experts = moe_mod.route(p, x.reshape(t, -1), cfg)
        counts = (experts.reshape(-1, 1) == torch.arange(
            cfg.n_experts, device=x.device)).sum(0)
        cap = moe_mod.expert_capacity(t, cfg)
        drops.append((current["rids"], (counts - cap).clamp(min=0).sum()))
        if caps is not None:
            caps.append((current["rids"] is not None, cap))
        return block(p, x, cfg)

    prefill = getattr(engine.bundle, prefill_field)

    def recording(params, batch):
        toks = batch["tokens"].cpu().numpy()
        lens = batch["lens"].cpu().numpy()
        current["rids"] = [by_prompt.get(tuple(toks[i, :n].tolist()))
                           for i, n in enumerate(lens)]
        try:
            return prefill(params, batch)
        finally:
            current["rids"] = None
    run = ServeEngine(dataclasses.replace(engine.bundle,
                                          **{prefill_field: recording}),
                      engine.params, engine.cfg, device=engine.device)
    done = swapped([(transformer_mod, "moe_block", counting)], run.run, reqs)
    per_rid, decode = {r.rid: 0 for r in reqs}, 0
    for rids, n in drops:
        n = int(n)
        if rids is None:
            decode += n
        for rid in rids or ():
            if rid is not None:
                per_rid[rid] += n
    return per_rid, decode, {r.rid: r.out for r in done}


def routing_flips(torch, a, b, rows) -> tuple:
    """(token, expert) choices of one run's route calls (``a``) absent in
    another's (``b``), over ``rows``: (total, rows with any flip)."""
    flips = torch.zeros(int(rows.sum()), dtype=torch.long,
                        device=rows.device)
    for ea, eb in zip(a, b):
        ea, eb = ea[rows], eb[rows]
        flips += (ea[:, :, None] != eb[:, None, :]).all(-1).sum(-1)
    return int(flips.sum()), flips > 0


def decode_step_gate(torch, params, engine, step, batch, tag):
    """One mid-run decode step: the gmm inputs it gave the kernel, and its
    logits with the kernel and with gmm_ref swapped in, over the active
    rows whose routing agrees in every layer (MOE_LOGIT_TOL); routing
    flips counted.  Returns (rel_err, flips, the gmm inputs)."""
    from repro_torch.kernels.moe_gmm import gmm_ref
    from repro_torch.models import moe as moe_mod
    active = batch["active"]
    gmm, route = moe_mod.gmm, moe_mod.route
    seen = {"gmm": [], "kernel": [], "plain": []}

    def rec_gmm(x, w):
        seen["gmm"].append((x, w))
        return gmm(x, w)

    def rec_route(which):
        def call(p, xf, cfg):
            out = route(p, xf, cfg)
            seen[which].append(out[2])
            return out
        return call

    def clone():
        return {k: v.clone() for k, v in engine.cache.items()}
    logits_k, _ = swapped([(moe_mod, "gmm", rec_gmm),
                           (moe_mod, "route", rec_route("kernel"))],
                          step, params, clone(), batch)
    logits_p, _ = swapped([(moe_mod, "gmm", gmm_ref),
                           (moe_mod, "route", rec_route("plain"))],
                          step, params, clone(), batch)
    if not torch.isfinite(logits_k).all():
        raise RuntimeError(f"{tag} non-finite decode-step logits")
    flips, flipped = routing_flips(torch, seen["kernel"], seen["plain"],
                                   active)
    keep = ~flipped
    n_active = int(active.sum())
    if 2 * int(flipped.sum()) > n_active:
        raise RuntimeError(f"{tag} decode step: routing flipped on "
                           f"{int(flipped.sum())} of {n_active} active rows "
                           f"between the kernel and gmm_ref")
    lk, lp = logits_k[active][keep], logits_p[active][keep]
    rel = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"{tag} decode step {engine.decode_steps}: logits gmm kernel vs "
        f"gmm_ref: rel_err={rel:.4g} (tol {MOE_LOGIT_TOL}) over "
        f"{int(keep.sum())} of {n_active} active rows, argmax agreement "
        f"{agree:.3f}; routing flips {flips} (token, expert) choices on "
        f"{int(flipped.sum())} rows, left out of the gate")
    if not rel <= MOE_LOGIT_TOL:
        raise RuntimeError(f"{tag} decode-step logits, gmm kernel vs "
                           f"gmm_ref: relative error {rel} over "
                           f"{MOE_LOGIT_TOL}")
    return rel, flips, seen["gmm"]


def check_gmm_paths(tag, paths, caps, n, stats) -> None:
    """Phase 12's path gate: a run's gmm launches by path against the
    capacities of its MoE calls (``caps`` from drop_accounting over the
    same requests, which the engine batches the same way): a call of
    capacity > 16 takes the wgmma path (prefill), one of capacity <= 16
    the decode path (every decode step, and a prefill of few enough
    tokens: 32 tokens give capacity 16 at dbrx-132b's top-4 of 16 experts
    and factor 1.25), and no launch takes another path."""
    if len(caps) != n * (stats["prefill_calls"] + stats["decode_steps"]):
        raise RuntimeError(f"{tag} the capacity run made {len(caps)} MoE "
                           f"calls; the measured run's schedule differs")
    want = dict.fromkeys(paths, 0)
    want["wgmma"] = 3 * sum(cap > 16 for _, cap in caps)
    want["decode"] = 3 * sum(cap <= 16 for _, cap in caps)
    pre = [cap for prefill, cap in caps if prefill]
    log(f"{tag} gmm launches by path {paths}: {3 * sum(c > 16 for c in pre)}"
        f" of the {3 * len(pre)} prefill launches on wgmma (capacities "
        f"{sorted(set(pre))}), every decode step's {3 * (len(caps) - len(pre))}"
        f" on the decode path")
    if paths != want or not all(cap <= 16 for prefill, cap in caps
                                if not prefill):
        raise RuntimeError(f"{tag} gmm launches by path {paths}, want "
                           f"{want}")


def peak_gb(torch, device) -> float:
    """Peak device memory since the last reset, GB (0 off the card)."""
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e9


def phase_moe(torch, device: str = "cuda", reduced: bool = False,
              arch: str = "dbrx-132b", n_layers: int = MOE_LAYERS,
              cache_len: int = 1024, lengths=(32, 700)):
    """dbrx-132b at its published widths cut to ``n_layers``: launcher,
    dense engine, paged engine, the launch, token and logits gates, and the
    gmm kernel at one prefill's and one decode step's inputs.  The keywords
    let the flow be rehearsed on the CPU at toy size."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.buckets import pad_length

    log(f"[{arch}] launcher: repro_torch.launch.serve.main --arch {arch} "
        f"--reduced --engine --paged")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", arch, "--reduced", "--engine", "--paged",
                       "--device", device, "--seed", str(SEED)])
    log(f"[{arch}] launcher done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg, bundle, params = load_model(torch, device, reduced, arch,
                                     0 if reduced else n_layers)
    n = cfg.n_layers
    slots, max_new, pad_to = 8, 16, 8

    def reqs():
        return burst_requests(cfg, max_new, lengths)
    results = {}
    for paged in (False, True):
        tag = f"[{arch}{' paged' if paged else ''}]"
        kind = "paged" if paged else "slotted"
        engine = ServeEngine(bundle, params, EngineConfig(
            slots=slots, cache_len=cache_len, pad_to=pad_to,
            max_prefill_batch=8, paged=paged, block_size=16), device=device)
        # the first run, also the warm-up: pairs dropped at capacity, and
        # the capacity of every MoE call
        caps = []
        drops, decode_drops, first = drop_accounting(
            torch, engine, reqs(), f"prefill_{kind}", caps)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        done = engine.run(reqs())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, stats = read_counts(), engine.stats()
        gmm_paths = read_paths("moe_gmm")
        if len(done) != 16 or not all(r.done and len(r.out) == max_new
                                      and not r.oom for r in done):
            raise RuntimeError(f"{tag} not every request finished with its "
                               f"tokens")
        decode = "paged_decode_attention" if paged else "decode_attention"
        other = "decode_attention" if paged else "paged_decode_attention"
        calls = stats["prefill_calls"] + stats["decode_steps"]
        check_launches(counts, {
            "moe_gmm": 3 * n * calls,
            "flash_attention": stats["prefill_calls"] * n,
            decode: stats["decode_steps"] * n, other: 0})
        check_gmm_paths(tag, gmm_paths, caps, n, stats)
        tokens = {r.rid: r.out for r in done}
        repeat = sum(first[rid] == tokens[rid] for rid in tokens)
        line = (f"{sum(drops.values())} pairs dropped at capacity in prefill "
                f"(requests {sorted(rid for rid, k in drops.items() if k)}), "
                f"{decode_drops} in decode; tokens equal to the first run's "
                f"for {repeat}/16 requests")
        if paged:
            dense = results["dense"]
            differ = sorted(rid for rid in tokens
                            if tokens[rid] != dense["tokens"][rid])
            # a pair dropped in a decode step couples every slot of it
            unexplained = [] if dense["decode_drops"] or decode_drops else [
                rid for rid in differ
                if not (drops[rid] or dense["drops"][rid])]
            line += (f"; tokens equal to the dense engine's for "
                     f"{16 - len(differ)}/16 requests"
                     + (f" (differ: {differ}, pairs dropped there dense / "
                        f"paged: {[(dense['drops'][r], drops[r]) for r in differ]})"
                        if differ else ""))
            if unexplained:
                raise RuntimeError(
                    f"{tag} paged tokens differ from the dense engine's for "
                    f"requests {differ}; {unexplained} dropped no pair in "
                    f"either run")
        split = split_run(torch, engine, {f"prefill_{kind}": "prefill",
                                          f"decode_{kind}": "decode"},
                          reqs())
        n_tok = sum(len(r.out) for r in done)
        log(f"{tag} engine: {len(done)} requests, max_new {max_new}, slots "
            f"{slots}, cache_len {cache_len}, pad_to {pad_to}"
            f"{', block_size 16' if paged else ''}: {n_tok} tokens in "
            f"{wall:.3f}s = {n_tok / wall:.1f} tok/s; stats {stats}; launches "
            f"{counts} (moe_gmm = 3 x {n} x ({stats['prefill_calls']} + "
            f"{stats['decode_steps']}), flash = {stats['prefill_calls']} x "
            f"{n}, {decode} = {stats['decode_steps']} x {n}); {line}")

        # one mid-run decode step: the gmm kernel vs gmm_ref, same state
        batch = mid_run_batch(torch, engine, reqs(), device)
        step = bundle.decode_paged if paged else bundle.decode_slotted
        rel, flips, sets = decode_step_gate(torch, params, engine, step,
                                            batch, tag)
        if len(sets) != 3 * n:
            raise RuntimeError(f"{tag} one decode step launched {len(sets)} "
                               f"gmm calls, want {3 * n}")
        step_ms = 1e3 * split["decode"][1] / max(split["decode"][0], 1)
        prof = profile_decode(torch, f"{tag}[profile]", step, params,
                              {k: v.clone() for k, v in engine.cache.items()},
                              batch, step_ms)
        share = None
        if prof is not None:
            busy, by_name = prof
            gmm_us = sum(t for name, (_, t) in by_name.items()
                         if "gmm_" in name)
            share = gmm_us / 3e3 / busy
            log(f"{tag}[profile] gmm kernel: {gmm_us / 3e3:.3f} ms of "
                f"{busy:.3f} ms device busy a step ({share:.3f})")
        results["paged" if paged else "dense"] = dict(
            tokens=tokens, counts=counts, gmm_paths=gmm_paths, stats=stats,
            wall=wall,
            tok_s=n_tok / wall, split=split, drops=drops,
            decode_drops=decode_drops, step_rel=rel, flips=flips,
            gmm_share=share, decode_sets=None if paged else sets)
        engine.reset()
        del engine, batch
        if paged:
            del sets

    # the kernel at the inputs one prefill (the longest prompt, in its
    # bucket of 8, alone) and one decode step gave it
    prompt = max((r.prompt for r in reqs()), key=len)
    length = pad_length(len(prompt), pad_to)
    toks = torch.zeros((1, length), dtype=torch.int32, device=device)
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device=device)
    seen = []
    gmm = moe_mod.gmm

    def rec_gmm(x, w):
        seen.append((x, w))
        return gmm(x, w)
    logits, _ = swapped([(moe_mod, "gmm", rec_gmm)], bundle.prefill_slotted,
                        params, {"tokens": toks, "lens": torch.tensor(
                            [len(prompt)], dtype=torch.int32, device=device),
                            "cache_len": cache_len})
    if len(seen) != 3 * n or not torch.isfinite(logits).all():
        raise RuntimeError(f"[{arch}] one prefill launched {len(seen)} gmm "
                           f"calls (want {3 * n}), or its logits are not "
                           f"finite")
    decode_sets = results["dense"].pop("decode_sets")
    paths = {"prefill": gmm_case_ms(torch, seen),
             "decode": gmm_case_ms(torch, decode_sets)}
    for which, sets, what in (("prefill", seen, f"a {length}-token bucket"),
                              ("decode step", decode_sets, f"{slots} slots")):
        r = paths[which.split()[0]]
        log(f"[kernel] moe_gmm at one {which}'s {len(sets)} launches of "
            f"{arch} (E={cfg.n_experts} C={sets[0][0].shape[1]} for {what}, "
            f"D/F={cfg.d_model}/{cfg.moe_d_ff}; per launch, averaged): "
            f"max_abs_err={r['err']:.3g}, {r['worst']:.3g} of the tolerance;"
            f" normwise {r['rel']:.3g} (tol {GMM_NORM_TOL[cfg.dtype]}) "
            f"{gmm_times(r)}")
    del seen, decode_sets
    peak = peak_gb(torch, device)
    d, p = results["dense"], results["paged"]
    log(f"[{arch}] {n} of {get_config(arch).n_layers} layers: tok/s dense "
        f"{d['tok_s']:.1f}, paged {p['tok_s']:.1f}; peak device memory "
        f"{peak:.2f} GB")
    results.update(paths=paths, peak_gb=peak)
    return results


def search_conv_launches(specs, forwards: int) -> int:
    """Conv kernel launches of a trained candidate: BN re-estimation (the
    pre-BN product, then the layer: two a conv; every conv of the space has
    BN) and one a conv for each of ``forwards`` no-grad forwards (its
    evaluation chunks; for the winner also its accumulator profile and its
    served batches)."""
    return sum(s.kind == "dwsep_conv" for s in specs) * (2 + forwards)


def phase_search(torch, data, device=None, card: str = "",
                 serve_steps: int = 300, serve_batch: int = 64,
                 bucket_steps: int = BUCKET_STEPS, profile_steps: int = 2,
                 **overrides) -> dict:
    """HALF's loop at the search space's full width: the search, then
    serve_winner, then one bucket trained batched and scalar, with phase
    13's gates; ``card`` (card_line()) is printed beside its rates.
    ``device`` None is the card, as for a user; ``device`` and
    ``overrides`` (NASConfig fields over SEARCH_CFG) let the flow be
    rehearsed on the CPU at toy size."""
    import dataclasses
    import threading

    import numpy as np

    import repro_torch.core.evolution as evolution_mod
    import repro_torch.hwlib.layers as layers_mod
    from repro_torch.core import trainer
    from repro_torch.core.evolution import EvolutionarySearch, NASConfig
    from repro_torch.core.genome import Genome, describe
    from repro_torch.core.objectives import expensive_objectives
    from repro_torch.core.trainer_batch import (fit_bucket, shape_signature,
                                                train_candidates_batched)
    from repro_torch.kernels.conv1d import dwsep_conv1d, dwsep_conv1d_ref
    from repro_torch.serve import serve_winner

    tr, va = data
    x_va, y_va = va
    n_val, chunks = len(y_va), -(-len(y_va) // 256)
    cfg = NASConfig(**{**SEARCH_CFG, **overrides})
    lines = []

    def search_log(msg):
        lines.append(str(msg))
        log(f"[search] {msg}")
    search = EvolutionarySearch(cfg, tr, va, log=search_log, device=device)
    dev, space = search.device, search.space
    log(f"[search] {cfg.generations} generations of {cfg.children_per_gen} "
        f"children, {cfg.n_accept} accepted, {cfg.init_population} initial, "
        f"{cfg.train_steps} steps at batch {cfg.train_batch}, "
        f"{cfg.n_workers} scheduler threads, pipeline {cfg.pipeline}, goal "
        f"{cfg.goal}, on {dev}; {len(tr[1])} train / {n_val} val records of "
        f"{tuple(tr[0].shape[1:])}; cut from the paper's run: {SEARCH_CUTS}")

    # every training call of the search, recorded before it runs (a retried
    # bucket would show up twice), with its host wall time
    attempted, specs_of, calls = [], {}, []
    lock = threading.Lock()

    def recording(genomes, *args, **kwargs):
        with lock:
            for g in genomes:
                attempted.append(g.phenotype_hash(space))
                specs_of[attempted[-1]] = g.phenotype(space)
        t0 = time.perf_counter()
        out = train_candidates_batched(genomes, *args, **kwargs)
        with lock:
            calls.append((len(genomes), time.perf_counter() - t0))
        return out

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = swapped([(evolution_mod, "train_candidates_batched", recording)],
                    search.run)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    hist = state.history
    host = {k: sum(r["timings"][k] for r in hist)
            for k in ("children", "cheap_score", "select")}
    host_s = sum(host.values())
    train_s = search_s - host_s
    n_trained = len(attempted)
    rates = dict(search_s=search_s, host_s=host_s, train_s=train_s,
                 candidates=n_trained,
                 candidates_per_s=n_trained / train_s)
    log(f"[search] {n_trained} candidates trained in {len(calls)} bucket "
        f"calls (sizes {sorted((n for n, _ in calls), reverse=True)}); wall "
        f"{search_s:.2f}s = host {host_s:.3f}s (mutate "
        f"{host['children']:.3f}, score {host['cheap_score']:.3f}, select "
        f"{host['select']:.3f}) + training {train_s:.2f}s (initial "
        f"population {search_s - sum(r['elapsed_s'] for r in hist):.2f}s);"
        f" {rates['candidates_per_s']:.3f} candidates trained/s; "
        f"generations: " + "; ".join(
            f"{r['generation']}: trained {r['trained']}, population "
            f"{r['population']}, front {r['front_size']}, feasible "
            f"{r['feasible']}" for r in hist))
    failed = [ln for ln in lines if "failed" in ln]
    if failed:
        raise RuntimeError(f"[search] training failed: {failed}")
    if n_trained != len(set(attempted)) \
            or set(attempted) != set(state.evaluated_hashes):
        raise RuntimeError(
            f"[search] {n_trained} trainings of {len(set(attempted))} "
            f"phenotypes, {len(state.evaluated_hashes)} in the dormant-gene "
            f"cache: a phenotype was trained twice or left out")
    if len(state.pop) > cfg.population_cap or len(hist) != cfg.generations \
            or not all(r["front_size"] >= 1 for r in hist):
        raise RuntimeError(f"[search] population {len(state.pop)} (cap "
                           f"{cfg.population_cap}), history {hist}")

    # the winner, trained, compiled and served behind two replicas
    t0 = time.perf_counter()
    served = serve_winner(search, state, data_train=tr, data_val=va,
                          train_steps=serve_steps,
                          train_batch=cfg.train_batch, seed=SEED,
                          replicas=2, log=search_log, device=device)
    torch.cuda.synchronize()
    winner_s = time.perf_counter() - t0
    winner = served.winner
    t0 = time.perf_counter()
    classes = [served.classify(x_va[i:i + serve_batch])
               for i in range(0, n_val, serve_batch)]
    serve_s = time.perf_counter() - t0
    launches = read_counts()["dwsep_conv1d"]
    n_batches = len(classes)
    classes = np.concatenate(classes)
    det, fa = trainer.detection_rates(classes, y_va)
    meta, wspecs = winner.train_meta, winner.genome.phenotype(space)
    rates["served_records_per_s"] = n_val / serve_s
    want = sum(search_conv_launches(specs_of[h], chunks) for h in attempted) \
        + search_conv_launches(wspecs, chunks + 1 + n_batches)
    log(f"[search] winner ({cfg.goal}): "
        f"{' '.join(s.short() for s in wspecs)} "
        f"{winner.genome.quant(space).short()}, input "
        f"{winner.input_length}; serve_winner: {serve_steps} steps, trained "
        f"and compiled "
        f"in {winner_s:.2f}s; {n_val} records in {n_batches} batches of "
        f"{serve_batch} behind 2 replicas in {serve_s * 1e3:.2f} ms = "
        f"{rates['served_records_per_s']:.1f} served records/s (host copies"
        f" included); served det {det:.4f} fa {fa:.4f}, validation det "
        f"{meta['detection_rate']:.4f} fa {meta['false_alarm_rate']:.4f}; "
        f"dwsep_conv1d launches {launches} (want {want}: conv layers x "
        f"no-grad forwards of the {n_trained} trained candidates and the "
        f"winner)")
    if launches != want:
        raise RuntimeError(f"dwsep_conv1d launched {launches} times in the "
                           f"search and serve_winner, want {want}")
    if len(classes) != n_val or served.stats["batches"] != n_batches:
        raise RuntimeError(f"[search] {len(classes)} classes for {n_val} "
                           f"records in {served.stats['batches']} batches")
    if (det, fa) != (meta["detection_rate"], meta["false_alarm_rate"]):
        raise RuntimeError(f"[search] served det/fa {det}/{fa}, the "
                           f"winner's validation {meta}")

    # one bucket at a time, trained batched and by scalar calls on the
    # card, BUCKET_STEPS steps each: the winner's phenotype at four quant
    # settings with one scalar run on records one f32 ulp up (reported:
    # see BUCKET_QUANTS; its batched call is the process's first vmapped
    # step and pays a one-time set-up), then phase 9's full-width phenotype
    # likewise (gated and timed)
    def bucket_of(genome):
        return [dataclasses.replace(genome, w_bits_gene=w, a_bits_gene=a,
                                    i_bits_gene=i)
                for w, a, i in BUCKET_QUANTS]

    def rates_of(results):
        return [(r.detection_rate, r.false_alarm_rate) for r in results]

    def batched_and_scalar(bucket):
        t0 = time.perf_counter()
        batched = train_candidates_batched(bucket, tr, va, **bucket_kw)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scalar = [trainer.train_candidate(g, tr, va, **bucket_kw)
                  for g in bucket]
        torch.cuda.synchronize()
        return batched, scalar, batched_s, time.perf_counter() - t0

    def val_loss_gap(a, b):
        return max(abs(p.val_loss - q.val_loss) for p, q in zip(a, b))

    bucket_kw = dict(space=space, steps=bucket_steps,
                     batch_size=cfg.train_batch, lr=cfg.lr, seed=SEED,
                     device=dev)
    w_bucket = bucket_of(winner.genome)
    w_batched, w_scalar, first_s, _ = batched_and_scalar(w_bucket)
    ulp = (np.nextafter(tr[0], np.float32(np.inf)), tr[1])
    w_ulp = trainer.train_candidate(w_bucket[0], ulp, va, **bucket_kw)
    rates["winner_bucket_first_batched_s"] = first_s
    log(f"[search] the winner's phenotype at {len(w_bucket)} quant settings"
        f" ({', '.join(g.quant(space).short() for g in w_bucket)}), "
        f"{bucket_steps} steps each (reported; the batched call, the "
        f"process's first vmapped step, took {first_s:.2f}s): det/fa "
        f"batched {rates_of(w_batched)}, scalar {rates_of(w_scalar)}; "
        f"largest |val_loss difference| "
        f"{val_loss_gap(w_batched, w_scalar):.3g}; its "
        f"{w_bucket[0].quant(space).short()} trained scalar on records one "
        f"f32 ulp up: det/fa {rates_of([w_ulp])[0]}, |val_loss difference| "
        f"{abs(w_ulp.val_loss - w_scalar[0].val_loss):.3g} from the "
        f"scalar run")

    bucket = bucket_of(Genome(**ECG_GENES))
    batched, scalar, batched_s, scalar_s = batched_and_scalar(bucket)
    steps = len(bucket) * bucket_steps
    rates.update(batched_steps_per_s=steps / batched_s,
                 scalar_steps_per_s=steps / scalar_s)
    log(f"[search] one bucket of phase 9's phenotype at {len(bucket)} quant "
        f"settings, {bucket_steps} steps each: batched {batched_s:.2f}s = "
        f"{rates['batched_steps_per_s']:.1f} steps/s, scalar {scalar_s:.2f}s"
        f" = {rates['scalar_steps_per_s']:.1f} steps/s (each with BN "
        f"re-estimation and evaluation); det/fa batched {rates_of(batched)}, "
        f"scalar {rates_of(scalar)}; largest |val_loss difference| "
        f"{val_loss_gap(batched, scalar):.3g} (tol {BATCH_VAL_LOSS_TOL})")
    for b, s in zip(batched, scalar):
        if not np.array_equal(expensive_objectives(b),
                              expensive_objectives(s)) \
                or not abs(b.val_loss - s.val_loss) < BATCH_VAL_LOSS_TOL:
            raise RuntimeError(f"[search] batched {b} differs from scalar "
                               f"{s}")

    # the bucket's training steps on the device (torch.profiler)
    want_len = bucket[0].input_length(space)
    x_tr = trainer.to_device(trainer.prep_inputs(tr[0], want_len), dev)
    y_tr = torch.as_tensor(tr[1], device=dev).long()
    sig = shape_signature(bucket[0], space)

    def fit(_):
        return fit_bucket(bucket, [SEED] * len(bucket), sig, space, x_tr,
                          y_tr, profile_steps, cfg.train_batch, cfg.lr, dev)
    fit(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(None)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    rates["bucket_step_ms"] = fit_ms / profile_steps
    prof = profile_forward(torch, "[search-profile]", fit, None, fit_ms,
                           what=f"the bucket's {profile_steps} batched "
                                f"steps")
    rates["bucket_idle_share"] = prof.get("idle_share")

    # one trained candidate (the bucket's w8a16i16): its eval logits with
    # the conv kernel and with the plain conv swapped in, and where its
    # evaluation's device time goes
    quant, specs = bucket[0].quant(space), bucket[0].phenotype(space)
    params, _ = trainer.fit_candidate(
        specs, quant, trainer.prep_inputs(tr[0], want_len), tr[1],
        steps=bucket_steps, batch_size=cfg.train_batch, lr=cfg.lr,
        seed=SEED, device=dev)
    xv = trainer.prep_inputs(x_va, want_len)

    @torch.no_grad()
    def eval_logits():
        return torch.cat([trainer.forward(
            params, specs, trainer.to_device(xv[i:i + 256], dev), quant)
            for i in range(0, n_val, 256)]).cpu().numpy()
    before = dwsep_conv1d.launches
    logits_k = eval_logits()
    kernel_launches = dwsep_conv1d.launches - before
    logits_p = swapped([(layers_mod, "dwsep_conv1d", dwsep_conv1d_ref)],
                       eval_logits)
    diff = np.abs(logits_k - logits_p)
    err = float(diff.max())
    # allclose at rtol = atol = tol: |err| <= tol + tol * |plain|
    share = float((diff / (ECG_LOGIT_TOL * (1 + np.abs(logits_p)))).max())
    log(f"[search] a trained candidate's eval logits ({n_val} records, "
        f"{quant.short()}), conv kernel ({kernel_launches} launches) vs "
        f"plain: max_abs_err={err:.3g}, {share:.3g} of the tolerance (rtol "
        f"= atol = {ECG_LOGIT_TOL}), |logits| max "
        f"{float(np.abs(logits_p).max()):.3g}")
    if not kernel_launches or not np.allclose(
            logits_k, logits_p, rtol=ECG_LOGIT_TOL, atol=ECG_LOGIT_TOL) \
            or not np.array_equal(logits_k.argmax(1), logits_p.argmax(1)):
        raise RuntimeError(f"[search] eval logits, kernel vs plain conv: "
                           f"max err {err}, or the classes differ, or no "
                           f"kernel launched ({kernel_launches})")

    def evaluation(_):
        return trainer.evaluate(params, specs, quant, xv, y_va, device=dev)
    evaluation(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluation(None)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_forward(torch, "[search-profile]", evaluation, None,
                           eval_ms, what=f"one evaluation ({n_val} records)")
    rates.update(eval_ms=eval_ms, eval_conv_share=prof.get("conv_share"),
                 eval_conv_ms=prof.get("conv_ms"))
    log(f"[search] rates on {card or dev}: {rates}")
    return dict(launches=launches, logit_err=err, rates=rates,
                winner=describe(winner.genome, space), state=state)


def gmm_entry(moe) -> dict:
    """The ``kernels`` line's entry for the grouped matmul, from phase 12:
    launches of the dense engine's run; times per launch over one decode
    step's inputs, and (``prefill_*``) one prefill's."""
    d, pre = moe["paths"]["decode"], moe["paths"]["prefill"]
    return {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:40",
        "launches": moe["dense"]["counts"]["moe_gmm"],
        "launches_by_path": moe["dense"]["gmm_paths"],
        "max_abs_err": max(d["err"], pre["err"]),
        "rel_err": max(d["rel"], pre["rel"]),
        "ms": d["ms"],
        "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"],
        "library_ms": d["library_ms"],
        "prefill_ms": pre["ms"],
        "prefill_plain_ms": pre["plain_ms"],
        "prefill_bound_ms": pre["bound_ms"],
        "prefill_bound_by": pre["bound_by"],
        "prefill_library_ms": pre["library_ms"],
        "library": "torch.bmm(x, w); launches from dbrx-132b's dense engine "
                   "run (8 of 40 layers); times per launch averaged over one "
                   "decode step's 24 launches (cap 8 at 8 slots), prefill_* "
                   "over one 704-token prefill's 24 (cap 224); rel_err is "
                   "the largest normwise error there, the gate",
    }


def tensor_core_report(build) -> None:
    """Phase 2's check of the tensor-core kernels: each one's registers
    and spills from ``-Xptxas -v`` (none may spill), any serialisation
    warning of ptxas (C7520: wgmma waits inserted by the compiler), and
    the count of wgmma instructions (HGMMA in the SASS) in each library."""
    for name in ("flash_attention", "moe_gmm"):
        lib = build.library_path(name)
        text = lib.with_suffix(".log").read_text()
        for entry in text.split("Compiling entry function")[1:]:
            kernel = re.search(r"'(\S+?)'", entry).group(1)
            if "wgmma_kernel" not in kernel:
                continue
            regs = re.search(r"Used (\d+) registers", entry).group(1)
            spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
            log(f"[build] {name} {kernel[-60:]}: {regs} registers, {spill} "
                f"bytes spill stores")
            if int(spill):
                raise RuntimeError(f"{name}: {kernel} spills {spill} bytes")
        serial = re.findall(r"C7520[^\n]*", text)
        # the toolkit is found where the build found nvcc
        cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        n_wgmma = sum("HGMMA" in line for line in sass.splitlines())
        log(f"[build] {name}: {n_wgmma} wgmma (HGMMA) instructions in the "
            f"SASS; ptxas serialisation warnings: {len(serial)}")
        if not n_wgmma or serial:
            raise RuntimeError(f"{name}: no wgmma in the library, or ptxas "
                               f"serialised it: {serial}")


def kernel_report(build, name: str, mma: bool, note: str = "") -> None:
    """Phase 2's check of one library's instantiations: their registers and
    spills from ``-Xptxas -v`` (none may spill) and, where ``mma``, the
    warp-level MMA (HMMA, mma.sync) instructions of its tensor-core path in
    the library's SASS (some must be there); ``note`` joins the line."""
    path = build.library_path(name)
    text = path.with_suffix(".log").read_text()
    kernels = []
    for entry in text.split("Compiling entry function")[1:]:
        kernel = re.search(r"'(\S+?)'", entry).group(1)
        regs = int(re.search(r"Used (\d+) registers", entry).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
        kernels.append((kernel, regs, spill))
    spilling = [(k, sp) for k, _, sp in kernels if sp]
    line = (f"[build] {name}: {len(kernels)} kernels, registers "
            f"{min((r for _, r, _ in kernels), default=0)}-"
            f"{max((r for _, r, _ in kernels), default=0)}, "
            f"{sum(sp for _, _, sp in kernels)} bytes spill stores"
            + (f"; {note}" if note else ""))
    n_mma = 0
    if mma:
        cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
        sass = subprocess.run([cuobjdump, "-sass", str(path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        n_mma = sum("HMMA" in ln for ln in sass.splitlines())
        line += f"; {n_mma} mma.sync (HMMA) instructions in the SASS"
    log(line)
    if not kernels or spilling or (mma and not n_mma):
        raise RuntimeError(f"{name}: spills {spilling}, or no mma.sync in "
                           f"the library ({n_mma} HMMA)")


def decode_report(build, lib) -> None:
    """Phase 2's check of the decode kernels (kernel_report), with the
    blocks of a cluster."""
    kernel_report(build, "decode_attention", mma=True,
                  note=f"clusters of {lib.decode_attention_cluster_blocks()}"
                       f" blocks")


def ratios(ms: float, **others: float) -> str:
    """The kernel's time over each yardstick, as 'kernel/name x'."""
    return ", ".join(f"kernel/{name} {ms / t:.2f}x" if t else
                     f"kernel/{name} not timed"
                     for name, t in others.items())


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
    tensor_core_report(_build)
    decode_report(_build, _build.load("decode_attention"))
    kernel_report(_build, "ssd", mma=True)
    kernel_report(_build, "dwsep_conv1d", mma=False)
    t_total = time.perf_counter()

    phase_kernels(torch, decode_attention, decode_attention_ref)
    phase_paged_kernels(torch)
    phase_flash_kernels(torch)
    phase_ssd_kernels(torch)
    phase_gmm_kernels(torch)
    launches, path, served = phase_serve(torch)
    paged_launches, paged_path = phase_paged_serve(torch, served["model"],
                                                   served["tokens"])
    phase_capacity(torch, served["model"])
    phase_router(torch, served["model"])
    del served
    torch.cuda.empty_cache()
    phase_conv_kernels(torch)
    conv_launches, conv_path, ecg = phase_ecg(torch)
    del ecg["winner"]
    torch.cuda.empty_cache()
    zamba = phase_hybrid(torch)
    del zamba["model"]
    torch.cuda.empty_cache()
    mamba = phase_mamba(torch)
    torch.cuda.empty_cache()
    moe = phase_moe(torch)
    torch.cuda.empty_cache()
    search = phase_search(torch, ecg["data"], card=card)
    zc, zp = zamba["dense"]["counts"], zamba["paths"]

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
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:125",
        "launches": paged_launches,
        "max_abs_err": paged_path["err"],
        "ms": paged_path["ms"],
        "plain_ms": paged_path["plain_ms"],
        "bound_ms": paged_path["bound_ms"],
        "bound_by": paged_path["bound_by"],
        "library_ms": paged_path["library_ms"],
        "gather_ms": paged_path["gather_ms"],
        "library": "two calls: gather_paged_kv (gather_ms), then "
                   "scaled_dot_product_attention on the gathered view "
                   "(library_ms)",
    }, {
        "name": "dwsep_conv1d",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dwsep_conv1d.cu",
        "replaces": "src/repro/kernels/conv1d/kernel.py:58",
        "launches": conv_launches,
        "search_launches": search["launches"],
        "max_abs_err": conv_path["err"],
        "ms": conv_path["ms"],
        "plain_ms": conv_path["plain_ms"],
        "bound_ms": conv_path["bound_ms"],
        "bound_by": conv_path["bound_by"],
        "library_ms": conv_path["library_ms"],
        "dw_ms": conv_path["dw_ms"],
        "pw_ms": conv_path["pw_ms"],
        "library": "two calls: depthwise F.conv1d(groups=C_in) (dw_ms), "
                   "then a 1x1 F.conv1d with bias and the ReLU (pw_ms); "
                   "times per launch, averaged over one deployment "
                   "forward's six convs at batch 256; max_abs_err also "
                   "over one BN re-estimation's and one evaluation's "
                   "launches without ReLU; launches from phase 9's run, "
                   "search_launches from phase 13's search and winner",
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:68",
        "launches": zc["ssd_scan"],
        "launches_by_path": zamba["dense"]["ssd_paths"],
        "max_abs_err": zp["ssd_scan"]["err"],
        "rel_err": zp["ssd_scan"]["rel"],
        "ms": zp["ssd_scan"]["ms"],
        "plain_ms": zp["ssd_scan"]["plain_ms"],
        "bound_ms": zp["ssd_scan"]["bound_ms"],
        "bound_by": zp["ssd_scan"]["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes the SSD scan; launches "
                   "from zamba2-7b's dense engine run, times per launch "
                   "averaged over one prefill's 81 scans; rel_err is the "
                   "largest normwise error of y and the state there, the "
                   "gate (max_abs_err is small only because y is)",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
        "launches": zc["flash_attention"],
        "max_abs_err": zp["flash_attention"]["err"],
        "ms": zp["flash_attention"]["ms"],
        "plain_ms": zp["flash_attention"]["plain_ms"],
        "bound_ms": zp["flash_attention"]["bound_ms"],
        "bound_by": zp["flash_attention"]["bound_by"],
        "library_ms": zp["flash_attention"]["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True); launches from zamba2-7b's dense engine "
                   "run, times per launch averaged over one prefill's 13 "
                   "shared-block applications (hd 112)",
    }, gmm_entry(moe)]
    log(f"[done] phases 3-13 in {time.perf_counter() - t_total:.1f}s; ecg "
        f"rates {ecg['rates']}; zamba2-7b tok/s dense "
        f"{zamba['dense']['tok_s']:.1f}, paged {zamba['paged']['tok_s']:.1f};"
        f" mamba2-780m tok/s {mamba['tok_s']:.1f}; dbrx-132b (8 layers) "
        f"tok/s dense {moe['dense']['tok_s']:.1f}, paged "
        f"{moe['paged']['tok_s']:.1f}; search {search['rates']}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
