#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. a CUDA device must be present; the card's name and power limit are read
   with nvidia-smi;
2. the port's CUDA sources are built (repro_torch/_build.py, nvcc for
   sm_90a), and the build seconds printed, with each wgmma kernel's
   registers and spills (none may spill; the flash kernel and the gmm
   forward, dX, decode and dW kernels must all be there), ptxas's wgmma
   serialisation warnings (none allowed) and each of those kernels' wgmma
   (HGMMA) instructions in its library's SASS (cuobjdump; some must be
   there); the
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
3c. the flash-attention kernel is held against its plain version, causal
   at the prefill shapes of qwen3-4b, qwen2-0.5b, zamba2-7b, dbrx-132b,
   granite-34b (48 heads over 1) and mistral-large-123b (96 over 8) (S 8,
   40, 704, 2048), f32 and bf16, and without a mask at whisper-
   tiny's encoder (B 8, 1,500 frames, 6/6 heads of 64) and cross-attention
   (4 queries against the 1,500 frames) in bf16 and at a ragged shape in
   bf16 and f32, each call on the path its dtype picks (bf16 the wgmma
   kernel, f32 the CUDA-core one) and counted under its mask, and timed
   beside the plain version, PyTorch's scaled_dot_product_attention (with
   is_causal as the call's) and its bound, with its TFLOP/s;
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
14. training: (a) the grouped matmul under autograd at dbrx-132b's
   prefill shape (bf16) and one f32 shape: its output has the Function's
   grad_fn, its backward launches the kernels twice on the operands as
   they lie (dx_wgmma and dw_wgmma in bf16, dx_f32 and dw_f32 in f32),
   dX and dW equal autograd through gmm_ref (phase 12's tolerances), and
   a second backward equals the first bit for bit; the Function's
   backward (its two launches) and dX and dW apart are timed beside their
   plain versions, torch.bmm and their bounds; (b)
   qwen2-0.5b at its published config (24 layers, vocab 151936, bf16,
   remat "full", 2 microbatches, AdamW) through
   repro_torch.launch.train.main, 30 steps at batch 8 x 512 with
   checkpoints every 10, then again with a failure injected at step 15:
   the first loss is near ln(vocab), the loss falls, the failed run
   restores step 10 and replays to the clean run bit for bit (all 30
   losses and the final params; and the losses within 2e-3 relative);
   steps/s and tokens/s over steps 2-29 with their checkpoint
   saves and over the whole run, the median step, peak memory, and one
   step's device time split into forward, backward, remat recompute and
   optimizer with its idle share (torch.profiler); (c) the eval step under
   no_grad launches the flash kernel once a layer, each launch's output
   equals flash_attention_ref on its own q, k and v (TOL), and the loss
   equals the gradient-taking pass's within 1e-4; (d) dbrx-132b reduced
   (remat "full", 2 microbatches, f32) trains 3 steps on the card: every
   expert grad finite and nonzero, gmm launches = 3 sites x layers x
   (forward + recompute + 2 backward) x microbatches x steps, step 1's
   expert grads elementwise and its loss and grad norm equal the CPU's
   from the same params (1e-4);
15. whisper-tiny at its published widths (4 + 4 layers, d_model 384, 6
   heads of 64, vocab 51865; bf16, random weights from a seed) through its
   bundle's prefill and decode_step: 8 clips of 1,500 frames and a 4-token
   prompt, a 448-token cache, 32 greedy steps.  Gates: flash launches =
   12 a prefill (4 encoder and 4 cross-attention unmasked, 4 causal),
   decode launches = 8 a step (self- and cross-attention); each flash
   launch equals flash_attention_ref on its own inputs; the prefill's and
   a decode step's logits equal those with the plain versions swapped in;
   row 0's tokens equal the same request's alone in the batch (the other
   rows empty; a batch of one is reported); 10 train steps on one fixed
   batch (8 x 1,500 frames, 187 decoder tokens): step 1's loss within 0.5
   of ln(vocab), the loss falls.  The cross-attention's decode launches
   are timed beside their plain version, SDPA and the bound; a decode
   step's and a prefill's device busy time and idle share are printed;
16. qwen2-vl-2b at its published widths (28 layers, d_model 1536, 12/2
   heads of 128, M-RoPE; bf16): a prefill of 4 x 1,024 embedded positions
   (16 text, a 16 x 16 patch grid, text) and 16 greedy decode steps.
   Gates: 28 flash launches a prefill, 28 decode launches a step, each
   flash launch against its plain version, the plain-swap logits gate;
   10 train steps at 8 x 512 (remat full, 2 microbatches, AdamW) on one
   fixed batch: the loss falls; peak memory and tokens/s printed;
17. the pod tooling, in two processes of its own: (a) an NCCL group of
   one rank and a (1, 1) ("data", "model") CUDA mesh; qwen2-0.5b at its
   published widths cut to 4 layers (3 train steps at 8 x 512 and one eval
   step on the flash kernel), dbrx-132b reduced as in 14d (one train step:
   gmm forward and backward on local shards) and qwen3-4b cut to 4 layers
   (a prefill of 4 x 128 and 8 greedy decode steps: flash and decode
   kernels), each run with plain params and again with
   ``distribute_params``'s DTensors under ``axis_rules``.  Gates: the
   losses, the eval loss, the params after the steps, the logits and the
   tokens equal bit for bit; each kernel's launches equal the plain run's
   and what the path makes (4 flash an eval step; 3 sites x 3 layers x 4
   passes x 2 microbatches gmm; 4 flash a prefill and 4 decode a step).
   The wall time of each with and without the mesh (and of each train
   step, and a second run of the others: the first fills DTensor's
   sharding caches) is printed; (b) the
   dry run (repro_torch.launch.dryrun.run_cell) on the fake (16, 16) mesh
   of 256 ranks: qwen3-4b x train_4k and x decode_32k, dbrx-132b x
   prefill_32k (on the EP path, its config's, and again on the sort
   path), zamba2-7b x long_500k at their published widths.  Gates:
   every cell ok, rank 0's param bytes equal what the specs imply exactly,
   dbrx-132b's EP cell moves all-to-all bytes and its sort cell none;
   each cell's peak bytes, flops, bytes, collective bytes by kind, the
   dominant term and useful_fraction are printed, and the EP cell's peak
   beside the sort cell's;
18. expert parallelism (repro's moe_block_ep), in two processes of its
   own: (a) an NCCL group of one rank and a (1, 1) mesh; kimi-k2 at its
   published widths (d_model 7168, 384 experts of 2048, top-8, a shared
   expert; bf16, random weights from a seed) cut to 1 of its 61 layers,
   its params as DTensors, so every MoE call takes the EP path: a prefill
   of 32 x 128 and 8 greedy decode steps.  Gates: 9 MoE calls on EP, gmm
   launches = 3 x 9, each on the path its capacity picks (c_loc 136:
   wgmma; 8: decode), each held to gmm_ref on its own inputs (normwise
   and elementwise, a slice of experts at a time); finite logits; on 128
   tokens of the prefill's MoE input, at the least capacity factor from 8
   up where neither path drops a pair (none may), the EP block equals the
   sort block normwise within 1e-2.  Printed: the init's peak memory, the
   prefill's and decode steps' wall ms, a warm prefill's and step's
   device busy ms and idle share, the pairs each path drops at the
   config's capacity (EP by stage), and the kernel's times at E 384 (one
   decode step's and the prefill's launches) beside gmm_ref, torch.bmm
   and the bound; (b) four gloo ranks, each a process on the one card
   (NCCL takes one rank a device), a (2, 2) mesh, dbrx-132b reduced
   (f32) at capacity 8: each rank's shard of the EP block's output and
   the load-balance loss equal the one-process sort path's within 1e-4,
   each rank launched gmm 3 times and dropped no pair;
19. granite-34b (d_model 6144, 48 heads over 1 KV head, d_ff 24576) and
   mistral-large-123b (d_model 12288, 96 over 8, d_ff 28672, rope_theta
   1e6) at their published widths (bf16, random weights from a seed), cut
   to 55 and 21 of their 88 layers (DENSE_LAYERS: ~60 GB each), each in a
   process of its own (``chip_smoke.py --phase-19 ARCH OUT``): the
   launcher on the reduced config (--engine --paged), then the first 8 of
   phase 4's 16 requests (DENSE_REQUESTS) through a dense ServeEngine (8
   slots, 1024-token cache) and a paged one (16-token blocks, worst-case
   pool of 512).  Gates: every request finishes; decode = layers x decode
   steps (dense; the paged kernel never), paged = layers x decode steps
   (paged; the dense kernel never), flash = layers x prefill calls; paged
   tokens equal dense tokens; one mid-run decode step's logits (dense and
   paged) and one 700-token prefill's first-token logits equal the same
   calls with the plain versions swapped in, normwise within LOGIT_TOL
   (the residual stream's distance after each layer printed beside it);
   each flash launch of that prefill against its plain version (TOL and
   FLASH_NORM_TOL).  Printed: params, GB and init seconds, tok/s and the
   prefill/decode split, a warm decode step's kernels, device busy ms
   and idle share (dense and paged), the flash kernel's times at that
   prefill's inputs beside its plain version, SDPA and the bound, peak
   memory, and the requests whose tokens equal the one-request oracle
   (not gated);
20. the last lines are the card (nvidia-smi), a JSON line of every kernel
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
# phases 3-3c also take the GQA groups wider than 8 heads of the two
# dense configs phase 19 serves cut in depth: granite-34b (MQA, 48 heads
# over 1) and mistral-large-123b (96 over 8); phase 3c also takes
# dbrx-132b's prefill attention (phase 12)
WIDE_GQA_SHAPES = {"granite-34b": (48, 1, 128),
                   "mistral-large-123b": (96, 8, 128)}
DECODE_SHAPES = {**ATTN_SHAPES, **WIDE_GQA_SHAPES}
FLASH_SHAPES = {**ATTN_SHAPES, "dbrx-132b": (48, 8, 128),
                **WIDE_GQA_SHAPES}
FLASH_LENGTHS = (8, 40, 704, 2048)
# Phase 19 serves granite-34b and mistral-large-123b at their published
# widths with the depth cut so that the bf16 weights fit one 80 GB card
# beside the caches and the prefill buffers: 55 of 88 layers (29.8 B
# params, 59.5 GB) and 21 of 88 (29.9 B, 59.7 GB); all 88 are 94.5 and
# 245 GB.  Each runs in a process of its own (``--phase-19 ARCH OUT``), so
# that it starts on an empty allocator.
DENSE_LAYERS = {"granite-34b": 55, "mistral-large-123b": 21}
# Phase 19's engines take the first 8 of phase 4's 16 requests (prompts of
# 32-521 tokens; its prefill gate still takes the burst's longest, 700).
# With all 16 the two children took 186.9 s on an NVIDIA H100 80GB HBM3
# at 700 W, over the phase's 150 s share of the script's time; the
# one-request oracle at batch 1 was 34 s of granite-34b's 116 s.
DENSE_REQUESTS = 8
# Phase 14a: the grouped matmul's backward (dX^T = gmm(W, dY^T), dW =
# gmm(X^T, dY)) at dbrx-132b's prefill shape (E, C, D, F) in bf16, and one
# f32 shape; kernel vs autograd through gmm_ref at GMM_TOL / GMM_NORM_TOL
GMM_BWD_CASES = [(16, 224, 6144, 10752, "bfloat16"),
                 (16, 40, 1024, 1536, "float32")]
# Phase 14b: qwen2-0.5b at its published config (24 layers, vocab 151936,
# bf16, remat "full", 2 microbatches, AdamW) trained through the launcher
# for 30 steps at batch 8 x 512 tokens, checkpoints every 10; the second
# run fails at step 15, restores step 10 and replays.  The reference's
# restart contract is bitwise (tests/test_checkpoint_loop.py: identical
# final params after injected failures), and every op of the step sums
# in an order fixed by its inputs (the embedding's backward sorts the ids
# and sums each row in a fixed tree; gmm's backward has no split-K), so
# the replayed run's losses at every step and its final params must equal
# the clean run's bit for bit.  The losses are also held to the clean
# run's within 2e-3 relative, and how far they moved is printed: the
# looser gate still tells a small drift from a broken restore should
# the bitwise one fail.
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_RUN = dict(steps=30, batch=8, seq=512, ckpt_every=10, fail_step=15)
TRAIN_REPLAY_TOL = 2e-3
# The first logged loss of a random init is near ln(vocab) (11.93 at
# 151936): within 0.5 of it; the mean of the last five steps' losses at
# least 0.5 below it.
TRAIN_FIRST_LOSS_TOL = 0.5
TRAIN_MIN_FALL = 0.5
# Phase 14c: the eval step under no_grad runs the flash kernel once a
# layer.  Each launch's output is held to flash_attention_ref on that
# launch's own q, k and v (B 8, S 512, 14/2 heads of 64, bf16) at
# TOL["bfloat16"]; the mean loss against the gradient-taking pass
# (chunked_attention) at 1e-4 relative (seen: 1e-5 and below on the H100).
EVAL_LOSS_TOL = 1e-4
# Phase 14d: dbrx-132b reduced (3 layers, 8 experts of 64, top-2, f32) with
# the published config's remat "full" and 2 microbatches, 3 steps on the
# card; step 1 against the same step on the CPU from the same params, f32
# sums in other orders: every expert leaf's gradient elementwise within
# 1e-4 of that leaf's largest magnitude, the loss and grad norm within
# 1e-4 relative.
MOE_TRAIN_STEPS = 3
MOE_TRAIN_TOL = 1e-4
# Phase 3c without a mask: whisper-tiny's encoder self-attention (B 8, 1,500
# frames, 6/6 heads of 64) and its prefill's cross-attention (a 4-token
# decoder prompt against the 1,500 frames) in bf16, a ragged case (Sq and
# Sk no multiple of any tile, a GQA group of 4 at hd 128) in bf16 and f32,
# and two where the last key tile is mostly past Sk (Sk 65: 63 of the 128
# keys two tiles hold are TMA's zero fill) at hd 64 and 128:
# (B, Sq, Sk, H, KVH, hd, dtype)
FLASH_FULL_CASES = {
    "whisper-tiny encoder": (8, 1500, 1500, 6, 6, 64, "bfloat16"),
    "whisper-tiny cross": (8, 4, 1500, 6, 6, 64, "bfloat16"),
    "ragged": (2, 77, 999, 8, 2, 128, "bfloat16"),
    "ragged f32": (2, 77, 999, 8, 2, 128, "float32"),
    "tail": (8, 4, 65, 6, 6, 64, "bfloat16"),
    "tail hd 128": (2, 77, 65, 8, 2, 128, "bfloat16"),
}
# Every flash call that phases 3b, 3c, 15 and 16 hold to its plain version
# must also be within FLASH_NORM_TOL normwise (||got - want|| / ||want||).
# allclose at TOL alone passes a kernel that drops the mask of the keys
# past Sk at whisper's shapes: random q and k give scores of spread ~1,
# 1,500 keys share the weight, and the last tile's 36 zero-filled keys
# (1,500 = 23 x 64 + 28) scoring 0 shrink every output by ~1.5%, which is
# within 2e-2 of values of ~0.04.  The
# limits sit between the sound kernel's largest reading and the reading of
# a build without that mask (tools/flash_tail_mask_check.py prints both;
# PERF.md has them).
FLASH_NORM_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# Phase 15: whisper-tiny at its published widths (4 + 4 layers, d_model
# 384, 6 heads of 64, d_ff 1536, vocab 51865; bf16, random weights from
# SEED): 8 clips of 1,500 frames (30 s at the stub frontend's rate,
# configs/shapes.py: ENCDEC_DECODE_ENC_LEN), a 4-token decoder prompt, a
# 448-token self-attention cache (whisper's decoder context), 32 greedy
# decode steps; then 10 train steps at the published config (remat none,
# 1 microbatch, AdamW) on one fixed batch of 8 x 1,500 frames and 187
# decoder tokens (1500 // dec_ratio).  Nothing is cut.
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_RUN = dict(batch=8, frames=1500, prompt=4, cache_len=448, steps=32,
                  train_steps=10)
# Phase 16: qwen2-vl-2b at its published widths (28 layers, d_model 1536,
# 12/2 heads of 128, d_ff 8960, vocab 151936, tied, M-RoPE 16/24/24; bf16,
# random weights from SEED): a prefill of 4 rows of 1,024 positions, each
# 16 text embeddings, a 16 x 16 patch grid (t fixed; h and w over its rows
# and columns) and text again from the grid's largest id + 1, embeddings
# from SEED; 16 greedy decode steps at the cache length; then 10 train
# steps at the published config (remat full, 2 microbatches, AdamW) on one
# fixed batch of 8 x 512 laid out the same way.  Nothing is cut.
VLM_ARCH = "qwen2-vl-2b"
VLM_RUN = dict(batch=4, seq=1024, text=16, grid=16, steps=16,
               train_batch=8, train_seq=512, train_steps=10)


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
    n_params, n_bytes = param_size(params)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params in {cfg.dtype} ({n_bytes / 1e9:.2f} "
        f"GB), init {time.perf_counter() - t0:.1f}s")
    return cfg, bundle, params


def param_size(params) -> tuple:
    """(elements, bytes) of a param tree."""
    tensors = list(_tensors(params))
    return (sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


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
        for by in ("launches_by_path", "launches_by_mask"):
            if hasattr(fn, by):
                setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))


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

    def chunked(q, k, v, causal=True):
        return attention_mod.chunked_attention(q, k, v, causal=causal,
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


def flash_errors(got, want) -> tuple:
    """A flash output against its plain version: (largest elementwise
    error, normwise error ||got - want|| / ||want||)."""
    diff = got.float() - want.float()
    return (float(diff.abs().max()),
            float(diff.norm() / want.float().norm().clamp_min(1e-30)))


def flash_flops(q, k=None, causal: bool = True) -> int:
    """4 hd flops per (query, key) pair attended (q.k and p.v) for every
    head: causal, query i sees keys 0..i (of Sk, k's length, default Sq);
    else all Sk keys."""
    b, sq, h, hd = q.shape
    sk = sq if k is None else k.shape[1]
    if not causal:
        pairs = sq * sk
    elif sq <= sk:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sk * (sk + 1) // 2 + (sq - sk) * sk
    return 4 * hd * h * b * pairs


def flash_bound_ms(q, k, causal: bool = True) -> tuple:
    """Least time for one flash attention call: q, k, v read once and the
    output written once; ``flash_flops`` of work."""
    item = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * item
    flops = flash_flops(q, k, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_flash_call(q, k, v, causal: bool = True):
    """PyTorch's own attention on the same (B, S, H, hd) inputs, causal
    (top-left, as the kernel's) or not (timed as the yardstick, never used
    by the port)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def flash_case_ms(torch, sets) -> dict:
    """Kernel vs plain on every set (q, k, v, causal): allclose at TOL and
    normwise within FLASH_NORM_TOL; then kernel, plain, SDPA and bound
    times per call over all sets, and the kernel's TFLOP/s.  On the card
    each call must take the path its dtype picks (bf16: the tensor-core
    kernel; f32: the CUDA-core one) and count under its mask."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    err, rel, lib_err = 0.0, 0.0, 0.0
    for q, k, v, causal in sets:
        paths = dict(flash_attention.launches_by_path)
        masks = dict(flash_attention.launches_by_mask)
        got = flash_attention(q, k, v, causal)
        want = flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        name = str(q.dtype).split(".")[-1]
        path = "wgmma" if name == "bfloat16" else "fma"
        mask = "causal" if causal else "full"
        if q.is_cuda and (flash_attention.launches_by_path[path]
                          != paths[path] + 1
                          or flash_attention.launches_by_mask[mask]
                          != masks[mask] + 1):
            raise RuntimeError(f"flash_attention {tuple(q.shape)} {name}: "
                               f"the call did not take the {path} path "
                               f"with the {mask} mask")
        e, r = flash_errors(got, want)
        if not (torch.allclose(got.float(), want.float(), rtol=TOL[name],
                               atol=TOL[name])
                and r <= FLASH_NORM_TOL[name]):
            raise RuntimeError(f"flash_attention {tuple(q.shape)} KVH "
                               f"{k.shape[2]} Sk {k.shape[1]} {mask} {name}: "
                               f"kernel disagrees with plain, max err {e} "
                               f"(tol {TOL[name]}), normwise {r} (tol "
                               f"{FLASH_NORM_TOL[name]})")
        err, rel = max(err, e), max(rel, r)
        lib_err = max(lib_err, float((sdpa_flash_call(q, k, v, causal)
                                      .float() - want.float()).abs().max()))
    bounds = [flash_bound_ms(q, k, causal) for q, k, _, causal in sets]
    ms = time_ms(flash_attention, sets)
    flops = sum(flash_flops(q, k, causal)
                for q, k, _, causal in sets) / len(sets)
    return dict(err=err, rel=rel, lib_err=lib_err, ms=ms,
                plain_ms=time_ms(flash_attention_ref, sets),
                library_ms=time_ms(sdpa_flash_call, sets),
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
                sets = [(*(torch.randn(1, s, n, hd, generator=gen,
                                       device=device, dtype=dtype)
                           for n in (h, kvh, kvh)), True)
                        for _ in range(n_sets)]
                r = flash_case_ms(torch, sets)
                name = str(dtype).split(".")[-1]
                log(f"[kernel] flash_attention {model} {name} B=1 S={s} "
                    f"H={h} KVH={kvh} hd={hd}: max_abs_err={r['err']:.3g} "
                    f"(tol {TOL[name]}), normwise {r['rel']:.3g} (tol "
                    f"{FLASH_NORM_TOL[name]}) ms={r['ms']:.4f} ({r['tflops']:.1f} "
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


def with_streams(swaps: list) -> tuple:
    """``swaps`` (for ``swapped``) plus a recorder of the residual stream
    after each transformer layer (transformer._mlp_residual's output);
    returns (the swaps, the list the recorder fills)."""
    import repro_torch.models.transformer as transformer_mod
    inner, out = transformer_mod._mlp_residual, []

    def record(*args):
        x = inner(*args)
        out.append(x)
        return x
    return swaps + [(transformer_mod, "_mlp_residual", record)], out


def drift_line(a: list, b: list, rows=None) -> tuple:
    """Where a gap between two runs grows: the normwise distance of each
    layer's residual stream, run ``a`` against run ``b`` (from
    with_streams; over ``rows`` of the batch), and a line that names it
    at five depths.  Empty for a model whose layers are not the
    transformer's."""
    drift = [rel_err(x if rows is None else x[rows],
                     y if rows is None else y[rows]) for x, y in zip(a, b)]
    if not drift:
        return drift, ""
    n = len(drift)
    at = sorted({1, max(n // 4, 1), max(n // 2, 1), max(3 * n // 4, 1), n})
    return drift, ("; residual stream kernels vs plain after layer "
                   + ", ".join(f"{i}: {drift[i - 1]:.3g}" for i in at))


def prefill_gate(torch, bundle, params, prompt, device, tag,
                 tol: float = HYBRID_LOGIT_TOL):
    """One exact-length prefill of ``prompt`` with the kernels, and again
    with the plain versions swapped in: the first-token logits must be
    finite and agree normwise within ``tol``.  Returns (relative error,
    the inputs of every SSD and flash launch of the kernel run, and under
    "drift" the residual stream's distance by layer: drift_line)."""
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
    swaps_k, streams_k = with_streams(
        [(mamba2_mod, "ssd_scan", rec_ssd),
         (attention_mod, "flash_attention", rec_flash)])
    swaps_p, streams_p = with_streams(plain_swaps())
    logits_k, _ = swapped(swaps_k, bundle.prefill_slotted, params, batch)
    logits_p, _ = swapped(swaps_p, bundle.prefill_slotted, params, batch)
    rel = rel_err(logits_k, logits_p)
    err = float((logits_k.float() - logits_p.float()).abs().max())
    seen["drift"], where = drift_line(streams_k, streams_p)
    del streams_k, streams_p
    log(f"{tag} prefill of {len(prompt)} tokens: first-token logits "
        f"kernels vs plain: rel_err={rel:.4g} (tol {tol}), max_abs_err="
        f"{err:.4g}, argmax equal "
        f"{bool(logits_k.argmax() == logits_p.argmax())}{where}")
    if not torch.isfinite(logits_k).all() or not rel <= tol:
        raise RuntimeError(f"{tag} prefill logits, kernels vs plain: "
                           f"relative error {rel} over {tol}, or not finite"
                           f"{where}")
    return rel, seen


def decode_logits_gate(torch, tag, step, params, engine, batch,
                       tol: float) -> float:
    """One mid-run decode step (``batch`` from mid_run_batch) with the
    kernels, and again with the plain versions swapped in, each from a
    copy of the engine's cache: the logits of the active rows must be
    finite and agree normwise within ``tol``.  Returns (the relative
    error, the residual stream's drift by layer: drift_line)."""
    active = batch["active"]

    def clone():
        return {k: v.clone() for k, v in engine.cache.items()}
    swaps_k, streams_k = with_streams([])
    swaps_p, streams_p = with_streams(plain_swaps())
    logits_k, _ = swapped(swaps_k, step, params, clone(), batch)
    logits_p, _ = swapped(swaps_p, step, params, clone(), batch)
    if not torch.isfinite(logits_k).all():
        raise RuntimeError(f"{tag} non-finite decode-step logits")
    lk, lp = logits_k[active].float(), logits_p[active].float()
    rel = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    drift, where = drift_line(streams_k, streams_p, active)
    log(f"{tag} decode step {engine.decode_steps}: logits kernels vs "
        f"plain: rel_err={rel:.4g} (tol {tol}), max_abs_err="
        f"{float((lk - lp).abs().max()):.4g}, argmax agreement {agree:.3f}"
        f"{where}")
    if not rel <= tol:
        raise RuntimeError(f"{tag} decode-step logits, kernels vs plain: "
                           f"relative error {rel} over {tol}{where}")
    return rel, drift


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
        step = bundle.decode_paged if paged else bundle.decode_slotted
        decode_logits_gate(torch, tag, step, params, engine, batch,
                           HYBRID_LOGIT_TOL)
        step_ms = 1e3 * split["decode"][1] / max(split["decode"][0], 1)
        profile_decode(torch, f"{tag}[profile]", step, params,
                       {k: v.clone() for k, v in engine.cache.items()},
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
                f"||x|| {r['y_over_x']:.3g} " if "tol_y" in r
                else f"normwise {r['rel']:.3g} (tol "
                f"{FLASH_NORM_TOL[cfg.dtype]}) ")
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
    every moe_block call.  A paged engine's steps run eagerly there, so
    that each calls the wrapper."""
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
    fields = {prefill_field: recording}
    if engine.paged:     # a replayed graph would not call the wrapper
        fields["decode_paged"] = engine.bundle.decode_paged.eager
    run = ServeEngine(dataclasses.replace(engine.bundle, **fields),
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


def gmm_grad_bound_ms(x, w, which=("dx", "dw")) -> tuple:
    """Least time for the backward's products of a grouped matmul (x: (E,
    C, D), w: (E, D, F)) named in ``which``: dX = dY W^T reads dY and W and
    writes dX; dW = X^T dY reads X and dY and writes dW; each is 2 E C D F
    flops.  The larger of their bytes over HBM's rate and their flops over
    the peak."""
    e, c, d = x.shape
    f = w.shape[2]
    per = {"dx": e * c * f + w.numel() + e * c * d,
           "dw": x.numel() + e * c * f + w.numel()}
    nbytes = sum(per[k] for k in which) * x.element_size()
    flops = len(which) * gmm_flops(x, w)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bmm_backward_call(x, w, dy):
    """PyTorch's own two products of the backward on the same inputs,
    strided transposes as bmm takes them (timed, never used by the port)."""
    import torch
    return (torch.bmm(dy, w.transpose(1, 2)),
            torch.bmm(x.transpose(1, 2), dy))


def gmm_backward_call(needs=(True, True)):
    """``GroupedMatmul.backward`` as autograd calls it, on (x, w, dy): the
    products ``needs`` asks for, each one launch on the card."""
    from repro_torch.kernels.moe_gmm.ops import GroupedMatmul

    def call(x, w, dy):
        class Ctx:
            saved_tensors = (x, w)
            needs_input_grad = needs
        return GroupedMatmul.backward(Ctx, dy)
    return call


def gmm_grad_paths(dtype) -> tuple:
    """The paths csrc/moe_gmm.cu's backward entry point should take for
    dX and dW of contiguous, TMA-able operands."""
    if str(dtype) == "torch.float32":
        return "dx_f32", "dw_f32"
    return "dx_wgmma", "dw_wgmma"


def phase_gmm_backward(torch, device: str = "cuda", cases=GMM_BWD_CASES,
                       timed: bool = True) -> list:
    """The grouped matmul under autograd: ``gmm``'s output has the
    Function's grad_fn, its backward launches the kernels twice (dX on
    one path, dW on another, on the operands as they lie), both gradients
    equal autograd through gmm_ref on the same card tensors, elementwise
    and normwise, and a second backward on the same inputs equals the
    first bit for bit.  Then dX and dW are timed apart and together (the
    whole Function, now just its two launches) beside their plain
    versions, torch.bmm and their bounds.  Returns each case's numbers."""
    from repro_torch.kernels.moe_gmm import (
        gmm,
        gmm_dw_ref,
        gmm_dx_ref,
        gmm_ref,
    )
    from repro_torch.kernels.moe_gmm.ops import GroupedMatmul
    results = []
    for e, c, d, f, name in cases:
        dtype = getattr(torch, name)
        gen = torch.Generator(device=device).manual_seed(SEED)
        x, w = gmm_inputs(torch, e, c, d, f, dtype, device, gen)
        dy = torch.randn(e, c, f, generator=gen, device=device).to(dtype)
        grads = []
        for _ in range(2):
            xg = x.clone().requires_grad_(True)
            wg = w.clone().requires_grad_(True)
            out = gmm(xg, wg)
            if not type(out.grad_fn).__name__.startswith(
                    GroupedMatmul.__name__):
                raise RuntimeError(f"gmm's output has grad_fn "
                                   f"{out.grad_fn}, not GroupedMatmul's")
            before, paths = gmm.launches, read_paths("moe_gmm")
            out.backward(dy)
            torch.cuda.synchronize()
            taken = {k: n - paths[k]
                     for k, n in read_paths("moe_gmm").items()
                     if n != paths[k]}
            want = dict.fromkeys(gmm_grad_paths(dtype), 1)
            if x.is_cuda and (gmm.launches != before + 2 or taken != want):
                raise RuntimeError(f"gmm's backward launched the kernels "
                                   f"{gmm.launches - before} times on "
                                   f"{taken}, want 2 on {want}")
            grads.append((xg.grad, wg.grad))
            del xg, wg, out
        repeats = all(torch.equal(a, b) for a, b in zip(*grads))
        if not repeats:
            raise RuntimeError(f"gmm backward E={e} C={c} D={d} F={f} "
                               f"{name}: two backward calls on the same "
                               f"inputs differ")
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        gmm_ref(xr, wr).backward(dy)
        err, rel, worst = 0.0, 0.0, 0.0
        for what, got, want in (("dX", grads[0][0], xr.grad),
                                ("dW", grads[0][1], wr.grad)):
            diff = (got.float() - want.float()).abs()
            tol = GMM_TOL[name]
            r = rel_err(got, want)
            ratio = float((diff / (tol + tol * want.float().abs())).max())
            if not (torch.isfinite(got).all() and r <= GMM_NORM_TOL[name]
                    and ratio <= 1.0):
                raise RuntimeError(
                    f"gmm backward {what} E={e} C={c} D={d} F={f} {name}: "
                    f"kernel disagrees with autograd through gmm_ref: "
                    f"normwise {r:.3g} (tol {GMM_NORM_TOL[name]}), max err "
                    f"{float(diff.max())}, {ratio:.3g} of the elementwise "
                    f"tolerance")
            err, rel = max(err, float(diff.max())), max(rel, r)
            worst = max(worst, ratio)
            del diff
        r = dict(case=(e, c, d, f, name), err=err, rel=rel, worst=worst,
                 repeats=repeats, paths=gmm_grad_paths(dtype))
        del grads, xr, wr
        torch.cuda.empty_cache()
        line = (f"[train] gmm backward E={e} C={c} D={d} F={f} {name}: dX "
                f"and dW max_abs_err={err:.3g}, {worst:.3g} of the "
                f"tolerance "
                f"(rtol = atol = {GMM_TOL[name]}); normwise {rel:.3g} (tol "
                f"{GMM_NORM_TOL[name]}); two backward calls equal bit for "
                f"bit; paths {r['paths'][0]}, {r['paths'][1]}")
        if timed:
            sets = [(x, w, dy)]

            def plain(x_, w_, dy_):
                return gmm_dx_ref(dy_, w_), gmm_dw_ref(x_, dy_)

            with torch.no_grad():
                r.update(ms=time_ms(gmm_backward_call(), sets),
                         plain_ms=time_ms(plain, sets, reps=3),
                         library_ms=time_ms(bmm_backward_call, sets),
                         dx_ms=time_ms(gmm_backward_call((True, False)),
                                       sets),
                         dw_ms=time_ms(gmm_backward_call((False, True)),
                                       sets),
                         dx_plain_ms=time_ms(
                             lambda x_, w_, dy_: gmm_dx_ref(dy_, w_), sets,
                             reps=3),
                         dw_plain_ms=time_ms(
                             lambda x_, w_, dy_: gmm_dw_ref(x_, dy_), sets,
                             reps=3),
                         dx_bmm_ms=time_ms(lambda x_, w_, dy_: torch.bmm(
                             dy_, w_.transpose(1, 2)), sets),
                         dw_bmm_ms=time_ms(lambda x_, w_, dy_: torch.bmm(
                             x_.transpose(1, 2), dy_), sets))
            r["bound_ms"], r["bound_by"] = gmm_grad_bound_ms(x, w)
            for which in ("dx", "dw"):
                r[f"{which}_bound_ms"], r[f"{which}_bound_by"] = \
                    gmm_grad_bound_ms(x, w, (which,))
            line += (f"; the Function's backward (its two launches) ms="
                     f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bmm_ms="
                     f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                     f"({r['bound_by']}), "
                     + ratios(r["ms"], bmm=r["library_ms"],
                              bound=r["bound_ms"]))
            for which, what in (("dx", "dX = dY W^T"),
                                ("dw", "dW = X^T dY")):
                line += (f"; {what} {r[f'{which}_ms']:.4f} ms (plain "
                         f"{r[f'{which}_plain_ms']:.4f}, bmm "
                         f"{r[f'{which}_bmm_ms']:.4f}, bound "
                         f"{r[f'{which}_bound_ms']:.4f} "
                         f"{r[f'{which}_bound_by']})")
        log(line)
        results.append(r)
        del x, w, dy
        torch.cuda.empty_cache()
    return results


def device_busy(torch, fn):
    """(fn's result, device busy ms, kernels, wall ms) of one call under
    torch.profiler (CUPTI); busy is None where the profiler saw no device
    kernel (the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
        if kernels else None
    return out, busy, len(kernels), wall_ms


def profile_train_step(torch, bundle, train_step, state, batch,
                       step_ms: float) -> dict:
    """Where one training step's device time goes (torch.profiler): the
    whole step, then its parts apart: the forward of every microbatch
    (loss_fn with a gradient taken, no backward), the gradients with
    cfg.remat and with remat "none" (backward = the latter less the
    forward; remat's recompute = the difference of the two), and the
    optimizer (clip, AdamW, the in-place update).  The idle share and the
    host's share are taken against ``step_ms``, the unprofiled step.
    Updates ``state``'s params in place; returns the numbers (empty where
    the profiler saw no device kernel)."""
    import dataclasses

    from repro_torch.models.registry import build_model
    from repro_torch.training.step import (
        loss_fn,
        make_train_step,
        requiring_grad,
    )
    cfg = bundle.cfg
    m = max(cfg.microbatches, 1)

    def forward():
        for i in range(m):
            mb = {k: v.chunk(m)[i] for k, v in batch.items()}
            with requiring_grad(state.params), torch.enable_grad():
                loss_fn(state.params, mb, bundle)

    plain_step, _ = make_train_step(
        build_model(dataclasses.replace(cfg, remat="none")))
    _, step_busy, step_kernels, step_wall = device_busy(
        torch, lambda: train_step(state, batch))
    _, fwd, fwd_k, _ = device_busy(torch, forward)
    (met, grads), full, full_k, _ = device_busy(
        torch, lambda: train_step.grads(state.params, batch))
    _, none, none_k, _ = device_busy(
        torch, lambda: plain_step.grads(state.params, batch))
    _, opt, opt_k, _ = device_busy(
        torch, lambda: train_step.update(state, grads, met))
    del grads
    if step_busy is None:
        log("[train] the profiler recorded no device kernels: a training "
            "step's split and idle share not measured")
        return {}
    out = dict(step_busy_ms=step_busy, step_kernels=step_kernels,
               step_ms=step_ms, idle_share=1 - step_busy / step_ms,
               host_ms=step_ms - step_busy, forward_ms=fwd,
               backward_ms=none - fwd, remat_ms=full - none,
               optimizer_ms=opt, kernels=dict(forward=fwd_k, grads=full_k,
                                              grads_no_remat=none_k,
                                              optimizer=opt_k))
    log(f"[train] one step: device busy {step_busy:.3f} ms over "
        f"{step_kernels} kernels (profiled wall {step_wall:.1f} ms); "
        f"unprofiled step {step_ms:.1f} ms -> device idle share "
        f"{out['idle_share']:.3f}, host beyond the device "
        f"{out['host_ms']:.1f} ms. Parts, device ms: forward {fwd:.3f} "
        f"({fwd_k} kernels), backward {none - fwd:.3f}, remat recompute "
        f"{full - none:.3f} (grads {full:.3f} with remat over {full_k} "
        f"kernels, {none:.3f} without over {none_k}), optimizer {opt:.3f} "
        f"({opt_k} kernels)")
    return out


def phase_train(torch, device: str = "cuda", arch: str = TRAIN_ARCH,
                reduced: bool = False, run=None, ckpt_root=None,
                min_fall: float = TRAIN_MIN_FALL) -> dict:
    """LM training through the port's launcher (repro_torch.launch.train):
    a clean run and a run that fails at ``fail_step`` and must restore the
    latest checkpoint and replay to the clean run's losses; then the eval
    step (no_grad: the flash kernel once a layer) against the gradient-
    taking pass, and one step profiled.  Checkpoints go under build/ and
    are removed."""
    import shutil

    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm import LMDataConfig, make_batch
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.step import (
        loss_fn,
        make_eval_step,
        make_train_step,
        requiring_grad,
    )
    run = dict(TRAIN_RUN, **(run or {}))
    steps, fail_step = run["steps"], run["fail_step"]
    root = Path(ckpt_root or ROOT / "build" / "chip_smoke_train")
    argv = ["--arch", arch, "--reduced" if reduced else "--no-reduced",
            "--steps", str(steps), "--batch", str(run["batch"]), "--seq",
            str(run["seq"]), "--ckpt-every", str(run["ckpt_every"]),
            "--log-every", "1", "--device", device]
    lines, stamps = [], []

    def logged(msg):
        # every restart line, and steps 0, 1 and every tenth; the wall
        # time at which each step's line came, for the rates
        lines.append(msg)
        parts = msg.split()
        step_line = parts[1:2] == ["step"] and parts[2].isdigit()
        if step_line:
            stamps.append((int(parts[2]), time.perf_counter()))
        if not (step_line and int(parts[2]) > 1 and int(parts[2]) % 10):
            log(f"[train] {msg}")

    fired = []

    def inject(step):
        if step == fail_step and not fired:
            fired.append(step)
            raise RuntimeError(f"injected node failure at step {step}")

    shutil.rmtree(root, ignore_errors=True)
    try:
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        clean = launch_train.main(argv + ["--ckpt-dir", str(root / "clean")],
                                  log=logged)
        clean_s = time.perf_counter() - t0
        at = dict(stamps)
        peak = peak_gb(torch, device)
        counts = read_counts()
        shutil.rmtree(root / "clean")
        t0 = time.perf_counter()
        faulty = launch_train.main(argv + ["--ckpt-dir",
                                           str(root / "faulty")],
                                   fail_injector=inject, log=logged)
        faulty_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if any(counts.values()):
        raise RuntimeError(f"training launched kernels {counts}: every "
                           f"attention takes a gradient (chunked_attention)")
    first, losses = clean["loss_at"][0], clean["loss_at"]
    want_first = math.log(cfg.vocab_size)
    tail = [losses[s] for s in range(steps - 5, steps)]
    if not (abs(first - want_first) <= TRAIN_FIRST_LOSS_TOL
            and sum(tail) / len(tail) <= first - min_fall
            and all(math.isfinite(v) for v in losses.values())):
        raise RuntimeError(f"training loss: first {first:.4f} (want within "
                           f"{TRAIN_FIRST_LOSS_TOL} of ln(vocab) = "
                           f"{want_first:.4f}), last five {tail} (want their "
                           f"mean {min_fall} below the first)")
    restored = (fail_step // run["ckpt_every"]) * run["ckpt_every"]
    if faulty["restarts"] != 1 or f"[loop] restored step {restored}" \
            not in lines or set(faulty["loss_at"]) != set(losses):
        raise RuntimeError(f"the failed run did not restore step {restored} "
                           f"and replay: restarts {faulty['restarts']}")
    replay = max(abs(faulty["loss_at"][s] - losses[s]) / abs(losses[s])
                 for s in losses)
    n_equal = sum(faulty["loss_at"][s] == losses[s] for s in losses)
    if replay > TRAIN_REPLAY_TOL:
        raise RuntimeError(f"the replayed run's losses differ from the clean "
                           f"run's by {replay:.3g} relative (tol "
                           f"{TRAIN_REPLAY_TOL})")
    leaves = list(zip(tree_leaves(clean["state"].params),
                      tree_leaves(faulty["state"].params)))
    params_differ = sum(not torch.equal(a, b) for a, b in leaves)
    if n_equal != len(losses) or params_differ:
        raise RuntimeError(f"the replayed run is not the clean run bit for "
                           f"bit: {n_equal} of {len(losses)} losses equal, "
                           f"{params_differ} of {len(leaves)} final param "
                           f"leaves differ")
    # The run's rate: steps 2 to the last on the wall clock, the checkpoint
    # saves between them included; the whole run's, its init, first steps
    # and last save included; the median step's, a per-step statistic
    # (no save, no init) that also sets the profile's idle share.
    window_s = at[steps - 1] - at[1]
    times = sorted(clean["seconds_at"][s] for s in range(2, steps))
    step_s = times[len(times) // 2]
    tokens = run["batch"] * run["seq"]
    out = dict(first=first, last=losses[steps - 1], replay=replay,
               n_equal=n_equal, params_equal=not params_differ,
               n_leaves=len(leaves), window_s=window_s,
               steps_per_s=(steps - 2) / window_s,
               tokens_per_s=(steps - 2) * tokens / window_s,
               run_tokens_per_s=steps * tokens / clean_s, step_s=step_s,
               median_tokens_per_s=tokens / step_s, peak_gb=peak,
               clean_s=clean_s, faulty_s=faulty_s, params=cfg.param_count())
    log(f"[train] {cfg.name} ({cfg.param_count() / 1e6:.1f} M params, "
        f"{cfg.n_layers} layers, {cfg.dtype}, remat {cfg.remat}, "
        f"{cfg.microbatches} microbatches): loss {first:.4f} (ln vocab "
        f"{want_first:.4f}) -> {losses[steps - 1]:.4f} in {steps} steps; "
        f"steps 2-{steps - 1} with their checkpoint saves in "
        f"{window_s:.2f} s = {out['steps_per_s']:.3f} steps/s, "
        f"{out['tokens_per_s']:.0f} tokens/s; the whole run (init and last "
        f"save in it) {clean_s:.2f} s = {out['run_tokens_per_s']:.0f} "
        f"tokens/s; per step, the median {step_s * 1e3:.1f} ms = "
        f"{out['median_tokens_per_s']:.0f} tokens/s; peak device memory "
        f"{peak:.2f} GB; the failing run {faulty_s:.1f} s (failing at step "
        f"{fail_step}, restoring step {restored}); replayed losses within "
        f"{replay:.3g} relative of the clean run's (tol {TRAIN_REPLAY_TOL}) "
        f"and {n_equal} of {len(losses)} bit for bit, final params equal "
        f"bit for bit in all {len(leaves)} leaves")

    # ---- (c) the eval step under no_grad, and (b) one step profiled ----
    bundle = build_model(cfg)
    state = faulty["state"]
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=run["seq"],
                            global_batch=run["batch"])
    batch = batch_to_device(make_batch(data_cfg, steps), torch.device(device))
    calls = []
    flash = attention_mod.flash_attention

    def recorded(q, k, v, causal=True):
        out = flash(q, k, v, causal)
        calls.append((q, k, v, causal, out))
        return out
    reset_counts()
    ev = swapped([(attention_mod, "flash_attention", recorded)],
                 make_eval_step(bundle), state.params, batch)
    eval_counts = read_counts()
    flash_err = 0.0
    for i, (q, k, v, causal, got) in enumerate(calls):
        want = flash_attention_ref(q, k, v, causal)
        e = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(),
                              rtol=TOL[cfg.dtype], atol=TOL[cfg.dtype]):
            raise RuntimeError(f"eval step: flash launch {i} at "
                               f"{tuple(q.shape)} KVH {k.shape[2]} "
                               f"{cfg.dtype} disagrees with its plain "
                               f"version on the same inputs, max err {e} "
                               f"(rtol = atol = {TOL[cfg.dtype]})")
        flash_err = max(flash_err, e)
    shape = tuple(calls[0][0].shape) if calls else None
    del calls, recorded
    with requiring_grad(state.params), torch.enable_grad():
        _, met = loss_fn(state.params, batch, bundle)
    grad_loss = float(met["loss"].detach())
    del met
    check_launches(read_counts(), {"flash_attention": cfg.n_layers})
    eval_rel = abs(float(ev["loss"]) - grad_loss) / abs(grad_loss)
    if eval_counts["flash_attention"] != cfg.n_layers or \
            eval_rel > EVAL_LOSS_TOL:
        raise RuntimeError(f"eval step: {eval_counts['flash_attention']} "
                           f"flash launches (want {cfg.n_layers}); loss "
                           f"{float(ev['loss']):.5f} vs {grad_loss:.5f} with "
                           f"a gradient ({eval_rel:.3g} relative, tol "
                           f"{EVAL_LOSS_TOL})")
    log(f"[train] eval step (no_grad): {eval_counts['flash_attention']} "
        f"flash launches a call, each at q {shape} against its plain "
        f"version on its own inputs: max_abs_err {flash_err:.3g} (allclose"
        f" at rtol = atol = {TOL[cfg.dtype]}); loss "
        f"{float(ev['loss']):.5f} vs "
        f"{grad_loss:.5f} with a gradient (chunked_attention), "
        f"{eval_rel:.3g} relative (tol {EVAL_LOSS_TOL})")
    out.update(eval_launches=eval_counts["flash_attention"],
               eval_rel=eval_rel, eval_flash_err=flash_err)
    train_step, _ = make_train_step(bundle)
    out["profile"] = profile_train_step(torch, bundle, train_step, state,
                                        batch, step_s * 1e3)
    del state, faulty, clean
    torch.cuda.empty_cache()
    return out


def phase_moe_train(torch, device: str = "cuda",
                    steps: int = MOE_TRAIN_STEPS, seq: int = 64,
                    batch: int = 4) -> dict:
    """MoE training on the card through the gmm kernel's forward and
    backward: dbrx-132b reduced with remat "full" and 2 microbatches.  Every
    expert leaf's gradient is finite and nonzero; the gmm launches equal
    call sites x (forward + remat recompute + 2 backward) x microbatches x
    steps; step 1's expert grads (elementwise), loss and grad norm equal
    the same step on the CPU from the same params."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.data.lm import LMDataConfig, make_batch
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.step import TrainState, make_train_step
    cfg = dataclasses.replace(reduced_config("dbrx-132b"), remat="full",
                              microbatches=2)
    bundle = build_model(cfg)
    cpu = torch.device("cpu")
    host_params = bundle.init(SEED, cpu)
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch)
    train_step, opt = make_train_step(bundle)
    params = tree_map(lambda t: t.to(device, copy=True), host_params)
    state = TrainState(0, params, opt.init(params))
    host_step, host_opt = make_train_step(bundle)
    host_raw, host_grads = host_step.grads(
        host_params, batch_to_device(make_batch(data_cfg, 0), cpu))
    reset_counts()
    met, grads = train_step.grads(
        state.params, batch_to_device(make_batch(data_cfg, 0),
                                      torch.device(device)))
    experts = [(f"layer {i} {k}", lp["moe"][k], hp["moe"][k])
               for i, (lp, hp) in enumerate(zip(grads["layers"],
                                                host_grads["layers"]))
               for k in ("gate", "up", "down")]
    bad = [name for name, g, _ in experts
           if not (torch.isfinite(g).all() and bool((g != 0).any()))]
    if bad:
        raise RuntimeError(f"expert grads not finite and nonzero: {bad}")
    # each expert leaf elementwise against the CPU's, as a share of the
    # leaf's largest magnitude
    grad_err = {name: float((g.cpu() - want).abs().max()
                            / want.abs().max())
                for name, g, want in experts}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > MOE_TRAIN_TOL:
        raise RuntimeError(f"dbrx-132b reduced step 1: expert grads on the "
                           f"card vs the CPU differ by up to "
                           f"{grad_err[worst]:.3g} of the leaf's largest "
                           f"magnitude at {worst} (tol {MOE_TRAIN_TOL})")
    state, met1 = train_step.update(state, grads, met)
    del grads, experts
    for s in range(1, steps):
        state, _ = train_step(state, batch_to_device(
            make_batch(data_cfg, s), torch.device(device)))
    torch.cuda.synchronize()
    counts = read_counts()
    passes = 1 + (cfg.remat != "none") + 2
    want = 3 * cfg.n_layers * passes * cfg.microbatches * steps
    check_launches(counts, {"moe_gmm": want})
    _, host_met = host_step.update(
        TrainState(0, host_params, host_opt.init(host_params)), host_grads,
        host_raw)
    rel = {k: abs(float(met1[k]) - float(host_met[k])) / abs(
        float(host_met[k])) for k in ("loss", "grad_norm")}
    if max(rel.values()) > MOE_TRAIN_TOL:
        raise RuntimeError(f"dbrx-132b reduced step 1 on the card vs the "
                           f"CPU: {rel} relative (tol {MOE_TRAIN_TOL})")
    log(f"[train] {cfg.name} (remat {cfg.remat}, {cfg.microbatches} "
        f"microbatches, {cfg.dtype}): {steps} steps, every expert grad "
        f"finite and nonzero; gmm launches {counts['moe_gmm']} = 3 sites x "
        f"{cfg.n_layers} layers x {passes} passes x {cfg.microbatches} "
        f"microbatches x {steps} steps (paths {read_paths('moe_gmm')}); "
        f"step 1's {len(grad_err)} expert grads elementwise within "
        f"{grad_err[worst]:.3g} of each leaf's largest magnitude of the "
        f"CPU's ({worst}; tol {MOE_TRAIN_TOL}); loss "
        f"{float(met1['loss']):.6f} / CPU "
        f"{float(host_met['loss']):.6f}, grad norm "
        f"{float(met1['grad_norm']):.6f} / {float(host_met['grad_norm']):.6f}"
        f" (relative {rel['loss']:.3g}, {rel['grad_norm']:.3g}; tol "
        f"{MOE_TRAIN_TOL})")
    return dict(launches=counts["moe_gmm"],
                backward_launches=3 * cfg.n_layers * 2 * cfg.microbatches
                * steps, rel=rel, grad_err=grad_err[worst])


def phase_flash_full_kernels(torch, device: str = "cuda",
                             cases=FLASH_FULL_CASES) -> dict:
    """Phase 3c without a mask: the flash kernel vs its plain version at
    whisper-tiny's encoder and cross-attention shapes and a ragged case,
    timed beside the plain version, SDPA(is_causal=False) and the bound.
    Returns each case's numbers by name."""
    out = {}
    for name, (b, sq, sk, h, kvh, hd, dt) in cases.items():
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=device).manual_seed(SEED)
        per = b * (sq * h + 2 * sk * kvh) * hd * dtype.itemsize
        n_sets = min(16, max(2, -(-200_000_000 // per)))
        sets = [(torch.randn(b, sq, h, hd, generator=gen, device=device,
                             dtype=dtype),
                 torch.randn(b, sk, kvh, hd, generator=gen, device=device,
                             dtype=dtype),
                 torch.randn(b, sk, kvh, hd, generator=gen, device=device,
                             dtype=dtype), False)
                for _ in range(n_sets)]
        r = flash_case_ms(torch, sets)
        log(f"[kernel] flash_attention {name} {dt} no mask B={b} Sq={sq} "
            f"Sk={sk} H={h} KVH={kvh} hd={hd}: max_abs_err={r['err']:.3g} "
            f"(tol {TOL[dt]}), normwise {r['rel']:.3g} (tol "
            f"{FLASH_NORM_TOL[dt]}) ms={r['ms']:.4f} ({r['tflops']:.1f} TFLOP/s) "
            f"plain_ms={r['plain_ms']:.4f} sdpa_ms={r['library_ms']:.4f} "
            f"(sdpa err {r['lib_err']:.3g}) bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}); eager call with host launch cost "
            f"{r['host_ms']:.4f} ms; "
            + ratios(r["ms"], sdpa=r["library_ms"], plain=r["plain_ms"],
                     bound=r["bound_ms"]))
        out[name] = r
        del sets
    return out


def decode_case_ms(torch, sets) -> dict:
    """The decode kernel vs its plain version on every set (q, k, v,
    kv_len) from a model's own call, then kernel, plain, SDPA and bound
    times per call over the sets."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )
    err = 0.0
    for args in sets:
        got, want = decode_attention(*args), decode_attention_ref(*args)
        torch.cuda.synchronize()
        name = str(args[0].dtype).split(".")[-1]
        e = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=TOL[name],
                              atol=TOL[name]):
            raise RuntimeError(f"decode_attention {tuple(args[1].shape)} "
                               f"{name}: kernel disagrees with plain, max "
                               f"err {e}")
        err = max(err, e)
    bounds = [attention_bound_ms(q, k, kv) for q, k, _, kv in sets]
    return dict(err=err, ms=time_ms(decode_attention, sets),
                plain_ms=time_ms(decode_attention_ref, sets),
                library_ms=time_ms(sdpa_call, sets),
                bound_ms=sum(t for t, _ in bounds) / len(bounds),
                bound_by=max(bounds)[1])


def _clone_cache(cache: dict) -> dict:
    return {k: v.clone() if hasattr(v, "clone") else v
            for k, v in cache.items()}


def recorded_prefill(torch, bundle, params, batch):
    """``bundle.prefill`` under no_grad with every flash launch recorded:
    (logits, cache, [(q, k, v, causal, out), ...])."""
    import repro_torch.models.attention as attention_mod
    calls = []
    flash = attention_mod.flash_attention

    def rec(q, k, v, causal=True):
        out = flash(q, k, v, causal)
        calls.append((q, k, v, causal, out))
        return out
    with torch.no_grad():
        logits, cache = swapped([(attention_mod, "flash_attention", rec)],
                                bundle.prefill, params, batch)
    return logits, cache, calls


def check_flash_calls(torch, tag, calls, dtype: str) -> tuple:
    """Each recorded flash launch against flash_attention_ref on its own
    q, k and v (allclose at TOL, normwise within FLASH_NORM_TOL): the
    largest elementwise and normwise errors."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    err, rel = 0.0, 0.0
    for i, (q, k, v, causal, got) in enumerate(calls):
        want = flash_attention_ref(q, k, v, causal)
        e, r = flash_errors(got, want)
        if not (torch.allclose(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
                and r <= FLASH_NORM_TOL[dtype]):
            raise RuntimeError(f"{tag} flash launch {i} at q "
                               f"{tuple(q.shape)} k {tuple(k.shape)} "
                               f"causal={causal} disagrees with its plain "
                               f"version on the same inputs, max err {e} "
                               f"(rtol = atol = {TOL[dtype]}), normwise {r} "
                               f"(tol {FLASH_NORM_TOL[dtype]})")
        err, rel = max(err, e), max(rel, r)
    return err, rel


def greedy_run(torch, bundle, params, batch, steps: int) -> tuple:
    """Prefill ``batch``, then ``steps`` greedy decode steps, under
    no_grad: (tokens (B, steps + 1), the cache, each step's wall ms)."""
    with torch.no_grad():
        logits, cache = bundle.prefill(params, batch)
        toks = [logits.argmax(-1)]
        step_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, cache = bundle.decode_step(params, cache,
                                               {"tokens": toks[-1][:, None]})
            toks.append(logits.argmax(-1))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(toks, 1), cache, step_ms


def swap_gates(torch, tag, bundle, params, batch, cache, token) -> tuple:
    """The logits of one prefill of ``batch`` and of one decode step of
    ``token`` from ``cache`` (cloned, so the cache is not written), with
    the kernels and with every kernel's plain version swapped in: normwise
    within LOGIT_TOL.  Returns the two relative errors."""
    calls = {"prefill": lambda: bundle.prefill(params, batch),
             "decode step": lambda: bundle.decode_step(
                 params, _clone_cache(cache), {"tokens": token})}
    out = []
    with torch.no_grad():
        for name, call in calls.items():
            lk, _ = call()
            lp, _ = swapped(plain_swaps(), call)
            rel = rel_err(lk, lp)
            agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            log(f"{tag} {name} logits, kernels vs plain versions: rel_err="
                f"{rel:.4g} (tol {LOGIT_TOL}), argmax agreement {agree:.3f}")
            if not torch.isfinite(lk).all() or not rel <= LOGIT_TOL:
                raise RuntimeError(f"{tag} {name} logits, kernels vs plain: "
                                   f"relative error {rel} over {LOGIT_TOL}, "
                                   f"or not finite")
            out.append(rel)
    return tuple(out)


def prefill_wall_ms(torch, bundle, params, batch) -> float:
    """Wall ms of one prefill of ``batch`` under no_grad, synchronised."""
    with torch.no_grad():
        t0 = time.perf_counter()
        bundle.prefill(params, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def serve_profile(torch, tag, bundle, params, batch, cache, token,
                  step_ms: float, prefill_ms: float) -> dict:
    """One decode step (the cache advances by one) and one prefill of
    ``batch`` under torch.profiler: each one's device busy ms and kernels,
    and its idle share against the unprofiled ``step_ms`` and
    ``prefill_ms``.  Empty where the profiler saw no device kernel."""
    out = {}
    runs = (("decode step", "", step_ms, lambda: bundle.decode_step(
                params, cache, {"tokens": token})),
            ("prefill", "prefill_", prefill_ms,
             lambda: bundle.prefill(params, batch)))
    for name, key, wall, call in runs:
        with torch.no_grad():
            _, busy, n_kernels, _ = device_busy(torch, call)
        if busy is None:
            log(f"{tag} the profiler recorded no device kernels: one "
                f"{name}'s device busy and idle share not measured")
            continue
        out.update({f"{key}busy_ms": busy, f"{key}kernels": n_kernels,
                    f"{key}ms" if key else "step_ms": wall,
                    f"{key}idle_share": 1 - busy / wall})
        log(f"{tag} one {name}: device busy {busy:.3f} ms over {n_kernels} "
            f"kernels; unprofiled {wall:.2f} ms -> device idle share "
            f"{1 - busy / wall:.3f}")
    return out


def train_fixed_batch(torch, tag, bundle, params, batch, steps: int,
                      device) -> dict:
    """``steps`` train steps (make_train_step at the config's remat,
    microbatches and AdamW) on one fixed batch, each synchronised and
    timed; params are updated in place.  Returns the losses, step seconds
    and the peak device memory."""
    from repro_torch.training.step import TrainState, make_train_step
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step, opt = make_train_step(bundle)
    state = TrainState(0, params, opt.init(params))
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = peak_gb(torch, device)
    del state, opt
    log(f"{tag} {steps} train steps on one fixed batch (remat "
        f"{bundle.cfg.remat}, {bundle.cfg.microbatches} microbatches, "
        f"AdamW): losses {[round(x, 4) for x in losses]}; step seconds "
        f"{[round(x, 3) for x in secs]}; peak device memory {peak:.2f} GB")
    return dict(losses=losses, secs=secs, peak_gb=peak)


def check_loss_falls(tag, losses, min_fall: float, first_near=None) -> None:
    """The mean of the last three losses at least ``min_fall`` below the
    first, all finite; with ``first_near`` (ln vocab), the first within
    TRAIN_FIRST_LOSS_TOL of it."""
    first, tail = losses[0], losses[-3:]
    if not (all(math.isfinite(x) for x in losses)
            and sum(tail) / len(tail) <= first - min_fall
            and (first_near is None
                 or abs(first - first_near) <= TRAIN_FIRST_LOSS_TOL)):
        raise RuntimeError(f"{tag} training loss: first {first:.4f}"
                           + (f" (want within {TRAIN_FIRST_LOSS_TOL} of ln "
                              f"vocab = {first_near:.4f})"
                              if first_near is not None else "")
                           + f", last three {tail} (want their mean "
                           f"{min_fall} below the first)")


def phase_encdec(torch, device: str = "cuda", reduced: bool = False,
                 run=None, min_fall: float = TRAIN_MIN_FALL) -> dict:
    """Phase 15: whisper-tiny (ENCDEC_RUN) through its bundle's prefill
    and decode_step, then training.  Gates: flash launches = encoder
    layers + 2 x decoder layers a prefill (the encoder's and the cross-
    attention unmasked, the decoder's self-attention causal), decode
    launches = 2 x decoder layers a step (self- and cross-attention); each
    flash launch equals its plain version on its own inputs; the prefill's
    and a decode step's logits equal those with the plain versions swapped
    in; row 0's tokens equal those of a one-request run and of the same
    request alone in the batch (the other rows empty); the train loss
    starts near ln(vocab) and falls."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.kernels.flash_attention import flash_attention
    run = dict(ENCDEC_RUN, **(run or {}))
    tag = "[encdec]"
    cfg, bundle, params = load_model(torch, device, reduced, ENCDEC_ARCH)
    b, t_enc, steps = run["batch"], run["frames"], run["steps"]
    n_enc, n_dec = cfg.n_layers, cfg.n_dec_layers
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(SEED)
    frames = torch.randn(b, t_enc, cfg.d_model, generator=gen,
                         device=device).to(dtype)
    prompt = torch.randint(0, cfg.vocab_size, (b, run["prompt"]),
                           generator=gen, device=device)
    batch = {"frames": frames, "dec_tokens": prompt,
             "cache_len": run["cache_len"]}

    reset_counts()
    logits, cache, calls = recorded_prefill(torch, bundle, params, batch)
    counts, masks = read_counts(), dict(flash_attention.launches_by_mask)
    check_launches(counts, {"flash_attention": n_enc + 2 * n_dec,
                            "decode_attention": 0})
    if masks != {"causal": n_dec, "full": n_enc + n_dec}:
        raise RuntimeError(f"{tag} prefill flash launches by mask {masks}: "
                           f"want causal {n_dec}, full {n_enc + n_dec}")
    flash_err, flash_rel = check_flash_calls(torch, tag, calls,
                                             cfg.dtype)
    shapes = sorted({(tuple(q.shape), k.shape[1], c)
                     for q, k, _, c, _ in calls})
    del calls
    log(f"{tag} {cfg.name} prefill of {b} x {t_enc} frames and a "
        f"{run['prompt']}-token prompt: flash launches "
        f"{counts['flash_attention']} (= {n_enc} + 2 x {n_dec}), by mask {masks}, at (q, Sk, causal) "
        f"{shapes}; each against its plain version on its own inputs: max "
        f"err {flash_err:.3g} (allclose at {TOL[cfg.dtype]}), normwise "
        f"{flash_rel:.3g} (tol {FLASH_NORM_TOL[cfg.dtype]})")

    # greedy decode, launches counted
    reset_counts()
    toks, cache, step_ms = greedy_run(torch, bundle, params, batch, steps)
    check_launches(read_counts(), {"decode_attention": 2 * n_dec * steps,
                                   "flash_attention": n_enc + 2 * n_dec})
    med = sorted(step_ms)[len(step_ms) // 2]
    prefill_ms = prefill_wall_ms(torch, bundle, params, batch)
    if not bool((toks >= 0).all() & (toks < cfg.vocab_size).all()):
        raise RuntimeError(f"{tag} greedy tokens out of the vocabulary")
    log(f"{tag} {steps} greedy decode steps at batch {b}: decode launches "
        f"{2 * n_dec * steps} (= 2 x {n_dec} x {steps}); a prefill "
        f"{prefill_ms:.2f} ms, a decode step {med:.2f} ms (median), "
        f"{b * steps / (sum(step_ms) / 1e3):.1f} tok/s over the steps")

    # the kernels against their plain versions, end to end
    last = toks[:, -1:]
    prefill_rel, decode_rel = swap_gates(torch, tag, bundle, params, batch,
                                         cache, last)

    # the cross-attention's decode launches, at one step's own inputs
    seen = []
    dec = attention_mod.decode_attention

    def rec_decode(q, k, v, kv_len):
        seen.append((q, k, v, kv_len))
        return dec(q, k, v, kv_len)
    with torch.no_grad():
        swapped([(attention_mod, "decode_attention", rec_decode)],
                bundle.decode_step, params, _clone_cache(cache),
                {"tokens": last})
    cross = decode_case_ms(torch, [a for a in seen if a[1].shape[1] == t_enc])
    log(f"[kernel] decode_attention at {tag}'s cross-attention (B={b}, "
        f"Sk={t_enc}, H={cfg.n_heads}, KVH={cfg.n_kv_heads}, hd="
        f"{cfg.resolved_head_dim}, {n_dec} launches of one step): max_abs_err"
        f"={cross['err']:.3g} ms={cross['ms']:.4f} plain_ms="
        f"{cross['plain_ms']:.4f} sdpa_ms={cross['library_ms']:.4f} bound_ms"
        f"={cross['bound_ms']:.4f} ({cross['bound_by']}); "
        + ratios(cross["ms"], sdpa=cross["library_ms"],
                 plain=cross["plain_ms"], bound=cross["bound_ms"]))
    del seen
    prof = serve_profile(torch, tag, bundle, params, batch, cache, last, med,
                         prefill_ms)
    del cache

    # row 0 as a request of its own: a batch of one, and the same shapes
    # with the other rows empty; both gated
    one = {"frames": frames[:1], "dec_tokens": prompt[:1],
           "cache_len": run["cache_len"]}
    toks_one, _, _ = greedy_run(torch, bundle, params, one, steps)
    alone = {"frames": torch.zeros_like(frames),
             "dec_tokens": torch.zeros_like(prompt),
             "cache_len": run["cache_len"]}
    alone["frames"][0], alone["dec_tokens"][0] = frames[0], prompt[0]
    toks_alone, _, _ = greedy_run(torch, bundle, params, alone, steps)
    n_one = int((toks_one[0] == toks[0]).sum())
    log(f"{tag} row 0's {steps + 1} greedy tokens equal a one-request run "
        f"at {n_one} of {steps + 1} positions, and the request alone in the "
        f"batch of {b} (other rows empty): "
        f"{bool(torch.equal(toks_alone[0], toks[0]))}")
    for name, other in (("a one-request run", toks_one),
                        ("the same request alone in the batch", toks_alone)):
        if not torch.equal(other[0], toks[0]):
            raise RuntimeError(f"{tag} row 0's tokens {toks[0].tolist()} "
                               f"differ from {name}'s "
                               f"{other[0].tolist()}")

    # training at the published config, on one fixed batch
    t_dec = t_enc // cfg.dec_ratio
    dec_tokens = torch.randint(0, cfg.vocab_size, (b, t_dec), generator=gen,
                               device=device)
    labels = torch.cat([dec_tokens[:, 1:], torch.randint(
        0, cfg.vocab_size, (b, 1), generator=gen, device=device)], 1)
    train_batch = {"frames": torch.randn(b, t_enc, cfg.d_model,
                                         generator=gen, device=device
                                         ).to(dtype),
                   "dec_tokens": dec_tokens, "labels": labels}
    reset_counts()
    tr = train_fixed_batch(torch, tag, bundle, params, train_batch,
                           run["train_steps"], device)
    if any(read_counts().values()):
        raise RuntimeError(f"{tag} training launched kernels "
                           f"{read_counts()}: every attention takes a "
                           f"gradient (chunked_attention)")
    check_loss_falls(tag, tr["losses"], min_fall,
                     first_near=math.log(cfg.vocab_size))
    tail = tr["secs"][1:] or tr["secs"]
    tr["tokens_per_s"] = b * t_dec * len(tail) / sum(tail)
    tr["frames_per_s"] = b * t_enc * len(tail) / sum(tail)
    log(f"{tag} training: loss {tr['losses'][0]:.4f} (ln vocab "
        f"{math.log(cfg.vocab_size):.4f}) -> {tr['losses'][-1]:.4f}; steps "
        f"2-{len(tr['secs'])}: {tr['frames_per_s']:.0f} frames/s, "
        f"{tr['tokens_per_s']:.0f} decoder tokens/s")
    return dict(counts=counts, masks=masks, flash_err=flash_err,
                flash_rel=flash_rel,
                prefill_rel=prefill_rel, decode_rel=decode_rel,
                decode_launches=2 * n_dec * steps, prefill_ms=prefill_ms,
                step_ms=med, tok_s=b * steps / (sum(step_ms) / 1e3),
                cross=cross, profile=prof, one_equal=n_one, train=tr)


def vlm_positions(torch, b: int, text: int, grid: int, total: int,
                  device) -> "torch.Tensor":
    """(3, b, total) M-RoPE ids: ``text`` tokens at (i, i, i), a ``grid``
    x ``grid`` patch grid at t = ``text`` with h and w running over its
    rows and columns from ``text``, then text again from the grid's
    largest id + 1, as Qwen2-VL lays out an image between text."""
    t = torch.arange(text)
    gh = torch.arange(grid * grid) // grid
    gw = torch.arange(grid * grid) % grid
    after = text + grid + torch.arange(total - text - grid * grid)
    pos = torch.stack([
        torch.cat([t, torch.full((grid * grid,), text), after]),
        torch.cat([t, text + gh, after]),
        torch.cat([t, text + gw, after])])
    return pos[:, None].expand(3, b, total).to(
        device=device, dtype=torch.int32).contiguous()


def vlm_batch(torch, cfg, b, seq, text, grid, gen, device) -> dict:
    """Embeddings (B, S, D) from ``gen`` at the token embeddings' scale
    (0.02) and the layout's positions."""
    return {"embeds": (0.02 * torch.randn(b, seq, cfg.d_model, generator=gen,
                                          device=device)).to(
                                              getattr(torch, cfg.dtype)),
            "positions": vlm_positions(torch, b, text, grid, seq, device)}


def phase_vlm(torch, device: str = "cuda", reduced: bool = False, run=None,
              min_fall: float = TRAIN_MIN_FALL) -> dict:
    """Phase 16: qwen2-vl-2b (VLM_RUN) through its bundle's prefill and
    decode_step, then training.  Gates: flash launches = layers a prefill
    (causal), decode launches = layers a step; each flash launch equals
    its plain version on its own inputs; the prefill's and a decode step's
    logits equal those with the plain versions swapped in; the train loss
    falls.  Peak memory and tokens/s are printed."""
    from repro_torch.kernels.flash_attention import flash_attention
    run = dict(VLM_RUN, **(run or {}))
    tag = "[vlm]"
    cfg, bundle, params = load_model(torch, device, reduced, VLM_ARCH)
    b, seq, steps = run["batch"], run["seq"], run["steps"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = dict(vlm_batch(torch, cfg, b, seq, run["text"], run["grid"], gen,
                           device), cache_len=seq + 2 * steps)
    reset_counts()
    logits, cache, calls = recorded_prefill(torch, bundle, params, batch)
    counts, masks = read_counts(), dict(flash_attention.launches_by_mask)
    check_launches(counts, {"flash_attention": cfg.n_layers,
                            "decode_attention": 0})
    if masks["causal"] != cfg.n_layers:
        raise RuntimeError(f"{tag} prefill flash launches by mask {masks}")
    flash_err, flash_rel = check_flash_calls(torch, tag, calls,
                                             cfg.dtype)
    shape = tuple(calls[0][0].shape)
    del calls, cache, logits
    log(f"{tag} {cfg.name} prefill of {b} x {seq} positions ({run['text']} "
        f"text, a {run['grid']} x {run['grid']} patch grid, then text): "
        f"flash launches {counts['flash_attention']} (= {cfg.n_layers}), "
        f"each at q {shape} against its plain version on its own inputs: "
        f"max err {flash_err:.3g} (allclose at {TOL[cfg.dtype]}), normwise "
        f"{flash_rel:.3g} (tol {FLASH_NORM_TOL[cfg.dtype]})")
    reset_counts()
    toks, cache, step_ms = greedy_run(torch, bundle, params, batch, steps)
    check_launches(read_counts(), {"decode_attention": cfg.n_layers * steps,
                                   "flash_attention": cfg.n_layers})
    med = sorted(step_ms)[len(step_ms) // 2]
    prefill_ms = prefill_wall_ms(torch, bundle, params, batch)
    log(f"{tag} {steps} greedy decode steps at batch {b}, positions {seq}-"
        f"{seq + steps - 1}: decode launches {cfg.n_layers * steps} (= "
        f"{cfg.n_layers} x {steps}); a prefill {prefill_ms:.2f} ms, a decode "
        f"step {med:.2f} ms (median), "
        f"{b * steps / (sum(step_ms) / 1e3):.1f} tok/s over the steps")
    last = toks[:, -1:]
    prefill_rel, decode_rel = swap_gates(torch, tag, bundle, params, batch,
                                         cache, last)
    prof = serve_profile(torch, tag, bundle, params, batch, cache, last, med,
                         prefill_ms)
    del cache, batch

    tb_, ts_ = run["train_batch"], run["train_seq"]
    train_batch = dict(vlm_batch(torch, cfg, tb_, ts_, run["text"],
                                 run["grid"], gen, device),
                       labels=torch.randint(0, cfg.vocab_size, (tb_, ts_),
                                            generator=gen, device=device))
    reset_counts()
    tr = train_fixed_batch(torch, tag, bundle, params, train_batch,
                           run["train_steps"], device)
    if any(read_counts().values()):
        raise RuntimeError(f"{tag} training launched kernels "
                           f"{read_counts()}")
    check_loss_falls(tag, tr["losses"], min_fall)
    tail = tr["secs"][1:] or tr["secs"]
    tr["tokens_per_s"] = tb_ * ts_ * len(tail) / sum(tail)
    log(f"{tag} training at {tb_} x {ts_}: loss {tr['losses'][0]:.4f} -> "
        f"{tr['losses'][-1]:.4f}; steps 2-{len(tr['secs'])}: "
        f"{tr['tokens_per_s']:.0f} tokens/s; peak {tr['peak_gb']:.2f} GB")
    return dict(counts=counts, flash_err=flash_err, flash_rel=flash_rel,
                prefill_rel=prefill_rel,
                decode_rel=decode_rel, decode_launches=cfg.n_layers * steps,
                prefill_ms=prefill_ms, step_ms=med,
                tok_s=b * steps / (sum(step_ms) / 1e3), profile=prof,
                train=tr)


# ---------------------------------------------------------------------------
# Phase 17: the pod tooling (DTensor on a one-card mesh; the dry run)
# ---------------------------------------------------------------------------

# 17a: each model once with no mesh and once on a (1, 1) mesh of one NCCL
# rank with its params as DTensors (random weights from SEED, bf16)
MESH_TRAIN = dict(arch="qwen2-0.5b", layers=4, steps=3, batch=8, seq=512)
MESH_MOE = dict(arch="dbrx-132b", batch=4, seq=64)      # phase 14d's config
MESH_SERVE = dict(arch="qwen3-4b", layers=4, batch=4, prompt=128,
                  cache_len=160, steps=8)
# 17b: the dry run's cells on the fake (16, 16) mesh of 256 ranks, each
# (arch, shape, config changes); dbrx-132b x prefill_32k takes the EP path
# (its config's ep_a2a), and again the sort path for comparison
DRYRUN_CELLS = (("qwen3-4b", "train_4k", {}), ("qwen3-4b", "decode_32k", {}),
                ("dbrx-132b", "prefill_32k", {}),
                ("dbrx-132b", "prefill_32k", {"moe_impl": "sort"}),
                ("zamba2-7b", "long_500k", {}))
CHILD_TIMEOUT_S = 300


def _same(torch, a, b) -> bool:
    """Bit for bit: every leaf of two trees (DTensors as their full
    tensors) equal, dtypes and shapes included."""
    from repro_torch.distributed.sharding import full_tree
    from repro_torch.optim.adamw import tree_leaves
    la, lb = tree_leaves(full_tree(a)), tree_leaves(full_tree(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _timed(torch, fn, device):
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_child(out_path: str, device: str = "cuda") -> int:
    """Phase 17a, in its own process: a process group of one rank (NCCL on
    the card, gloo on the CPU), a (1, 1) ("data", "model") mesh, and each
    run twice, with plain params and with ``distribute_params``'s DTensors
    under ``axis_rules``; results to ``out_path`` as JSON."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm import LMDataConfig, make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.step import (
        TrainState,
        make_eval_step,
        make_train_step,
    )
    mesh = make_mesh((1, 1), ("data", "model"), dev.type)
    out: dict = {"train": {}, "moe": {}, "serve": {}}

    def twice(name, arch, batch, run, again=False):
        """``run(mesh_or_None)`` with no mesh, then on the mesh, each with
        the counts at 0 just before it and read just after; (its two
        results, the counts, the wall ms).  ``again``: both once more,
        timed only (the first mesh run fills DTensor's caches)."""
        res = {}
        rules = rules_for(arch, multi_pod=False, global_batch=batch)
        runs = (("plain", None), ("mesh", mesh))
        for tag, m in runs + ((("plain_again", None), ("mesh_again", mesh))
                              if again else ()):
            reset_counts()
            with sh.axis_rules(rules if m is not None else None, m):
                got, ms = _timed(torch, lambda: run(m), dev)
            if not tag.endswith("again"):
                res[tag] = got
                res[tag + "_counts"] = read_counts()
            res[tag + "_ms"] = ms
        out[name].update({k: v for k, v in res.items()
                          if k.endswith(("_counts", "_ms"))})
        return res

    # ---- qwen2-0.5b, 4 layers: 3 train steps and one eval step ----------
    t = MESH_TRAIN
    cfg = dataclasses.replace(get_config(t["arch"]), n_layers=t["layers"],
                              **t.get("cfg", {}))
    bundle = build_model(cfg)
    params0 = bundle.init(SEED, dev)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                        global_batch=t["batch"])
    host = [make_batch(data, s) for s in range(t["steps"] + 1)]

    def train(m):
        params = tree_map(lambda x: x.clone(), params0)
        if m is not None:
            params = sh.distribute_params(params, bundle.specs(),
                                          sh.current_rules(), m)
        step, opt = make_train_step(bundle)
        state = TrainState(0, params, opt.init(params))
        losses, step_ms = [], []
        for b in host[:t["steps"]]:
            (state, met), ms = _timed(torch, lambda: step(
                state, batch_to_device(b, dev, bundle, m)), dev)
            losses.append(met["loss"])
            step_ms.append(ms)
        out["train"][("mesh" if m is not None else "plain")
                     + "_step_ms"] = step_ms
        reset_counts()      # the eval step's launches alone
        ev = make_eval_step(bundle)(state.params, batch_to_device(
            host[-1], dev, bundle, m))
        return dict(losses=losses, eval=ev["loss"], params=state.params)
    r = twice("train", t["arch"], t["batch"], train)
    out["train"]["same"] = dict(
        losses=_same(torch, r["plain"]["losses"], r["mesh"]["losses"]),
        eval=_same(torch, r["plain"]["eval"], r["mesh"]["eval"]),
        params=_same(torch, r["plain"]["params"], r["mesh"]["params"]))
    out["train"]["losses"] = [float(x) for x in r["plain"]["losses"]]
    del r, params0

    # ---- dbrx-132b reduced (phase 14d's config): one train step, on the
    # sort path with and without the mesh (on a mesh the config's ep_a2a
    # takes the EP path, another function; phase 18 holds that one)
    t = MESH_MOE
    cfg = dataclasses.replace(reduced_config(t["arch"]), remat="full",
                              microbatches=2, moe_impl="sort")
    bundle = build_model(cfg)
    params0 = bundle.init(SEED, dev)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                        global_batch=t["batch"])

    def moe(m):
        params = tree_map(lambda x: x.clone(), params0)
        if m is not None:
            params = sh.distribute_params(params, bundle.specs(),
                                          sh.current_rules(), m)
        step, opt = make_train_step(bundle)
        state, met = step(TrainState(0, params, opt.init(params)),
                          batch_to_device(make_batch(data, 0), dev, bundle,
                                          m))
        return dict(loss=met["loss"], grad_norm=met["grad_norm"],
                    params=state.params)
    r = twice("moe", t["arch"], t["batch"], moe, again=True)
    out["moe"]["same"] = dict(
        loss=_same(torch, r["plain"]["loss"], r["mesh"]["loss"]),
        grad_norm=_same(torch, r["plain"]["grad_norm"],
                        r["mesh"]["grad_norm"]),
        params=_same(torch, r["plain"]["params"], r["mesh"]["params"]))
    out["moe"]["want_gmm"] = 3 * cfg.n_layers * 4 * cfg.microbatches
    del r, params0

    # ---- qwen3-4b, 4 layers: one prefill and 8 greedy decode steps ------
    t = MESH_SERVE
    cfg = dataclasses.replace(get_config(t["arch"]), n_layers=t["layers"],
                              **t.get("cfg", {}))
    bundle = build_model(cfg)
    params0 = bundle.init(SEED, dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (t["batch"], t["prompt"]),
                           generator=gen).to(dev)

    def serve(m):
        params = params0
        rules = sh.current_rules()
        if m is not None:
            params = sh.distribute_params(params, bundle.specs(), rules, m)
        toks = prompt if m is None else sh.distribute_params(
            {"t": prompt}, {"t": ("batch", "seq")}, rules, m)["t"]
        with torch.no_grad():
            logits, cache = bundle.prefill(params, {
                "tokens": toks, "cache_len": t["cache_len"]})
            first = logits
            tokens = []
            for _ in range(t["steps"]):
                nxt = logits.argmax(-1)[:, None]
                tokens.append(nxt)
                logits, cache = bundle.decode_step(params, cache,
                                                   {"tokens": nxt})
        return dict(logits=first, last=logits, tokens=tokens)
    r = twice("serve", t["arch"], t["batch"], serve, again=True)
    out["serve"]["same"] = dict(
        logits=_same(torch, r["plain"]["logits"], r["mesh"]["logits"]),
        last=_same(torch, r["plain"]["last"], r["mesh"]["last"]),
        tokens=_same(torch, r["plain"]["tokens"], r["mesh"]["tokens"]))
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


def dryrun_child(out_path: str) -> int:
    """Phase 17b, in its own process: DRYRUN_CELLS through
    ``repro_torch.launch.dryrun.run_cell`` on the fake (16, 16) mesh;
    each cell's report and details to ``out_path`` as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    cells = []
    for arch, shape, change in DRYRUN_CELLS:
        details: dict = {}
        t0 = time.perf_counter()
        rep = dryrun.run_cell(arch, shape, False, details=details,
                              cfg_overrides=change or None)
        cells.append(dict(report=rep.to_dict(), details=details,
                          changes=change, wall_s=time.perf_counter() - t0))
    Path(out_path).write_text(json.dumps(cells))
    return 0


def _child(flag: str, tag: str, *args: str, echo: str = "[dryrun]"
           ) -> object:
    """Run this script with ``flag``, ``args`` and an output path in a
    process of its own; its JSON.  The child's stdout lines that start
    with ``echo`` are logged here."""
    out = ROOT / "build" / f"chip_smoke_{tag.replace(' ', '_')}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag,
                           *args, str(out)], capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S, cwd=ROOT)
    for line in done.stdout.splitlines():
        if line.startswith(echo):
            log(line)
    if done.returncode != 0 or not out.exists():
        raise RuntimeError(f"phase {tag} exited {done.returncode}:\n"
                           f"{done.stdout[-3000:]}\n{done.stderr[-6000:]}")
    log(f"[{tag}] its process took {time.perf_counter() - t0:.1f}s")
    result = json.loads(out.read_text())
    out.unlink()
    return result


def phase_mesh() -> dict:
    """Phase 17a: the mesh runs equal the plain runs bit for bit, with
    equal kernel launches, and those launches are what the paths make."""
    r = _child("--phase-17a", "17a")
    bad = {f"{name}.{k}": v for name in ("train", "moe", "serve")
           for k, v in r[name]["same"].items() if not v}
    for name in ("train", "moe", "serve"):
        if r[name]["plain_counts"] != r[name]["mesh_counts"]:
            bad[f"{name} launches"] = (r[name]["plain_counts"],
                                       r[name]["mesh_counts"])
    t, m, s = MESH_TRAIN, r["moe"], MESH_SERVE
    want = {"train": {"flash_attention": t["layers"]},
            "moe": {"moe_gmm": m["want_gmm"]},
            "serve": {"flash_attention": s["layers"],
                      "decode_attention": s["layers"] * s["steps"]}}
    for name, w in want.items():
        got = {k: r[name]["mesh_counts"][k] for k in w}
        if got != w:
            bad[f"{name} launches vs the path"] = (got, w)
    if bad:
        raise RuntimeError(f"phase 17a: the (1, 1) mesh differs from no "
                           f"mesh: {bad}")
    for name, what in (("train", f"{t['arch']} ({t['layers']} layers) "
                                 f"{t['steps']} train steps at {t['batch']}"
                                 f" x {t['seq']} and one eval step"),
                       ("moe", f"{MESH_MOE['arch']} reduced, one train step"
                               f" (remat full, 2 microbatches)"),
                       ("serve", f"{s['arch']} ({s['layers']} layers) one "
                                 f"prefill of {s['batch']} x {s['prompt']} "
                                 f"and {s['steps']} decode steps")):
        x = r[name]
        steps = (f"; train steps {[round(v, 1) for v in x['plain_step_ms']]}"
                 f" ms without, {[round(v, 1) for v in x['mesh_step_ms']]} "
                 f"ms with") if name == "train" else (
            f"; again {x['plain_again_ms']:.1f} ms without, "
            f"{x['mesh_again_ms']:.1f} ms with "
            f"({x['mesh_again_ms'] / x['plain_again_ms']:.2f}x)")
        log(f"[mesh] {what}: bit for bit on the (1, 1) mesh "
            f"({', '.join(x['same'])}); launches "
            f"{ {k: v for k, v in x['mesh_counts'].items() if v} }; wall "
            f"{x['plain_ms']:.1f} ms without the mesh, {x['mesh_ms']:.1f} "
            f"ms with it ({x['mesh_ms'] / x['plain_ms']:.2f}x){steps}")
    return r


def cell_name(c: dict) -> str:
    """'arch x shape', with the cell's config changes."""
    rep, change = c["report"], c.get("changes")
    return f"{rep['arch']} x {rep['shape']}" + (f" {change}" if change
                                                 else "")


def phase_dryrun() -> list:
    """Phase 17b: every cell ok, and rank 0's param bytes equal what the
    specs imply exactly; a MoE cell moves all-to-all bytes on the EP path
    and none on the sort path."""
    cells = _child("--phase-17b", "17b")
    bad = [cell_name(c) for c in cells
           if not c["report"]["ok"] or c["details"]["param_bytes"]
           != c["details"]["param_bytes_implied"]]
    if bad:
        raise RuntimeError(f"phase 17b: cells not ok or param bytes not "
                           f"exact: {bad}")
    moe = {(c.get("changes") or {}).get("moe_impl", "ep_a2a"):
           c["report"] for c in cells if c["report"]["arch"] == "dbrx-132b"}
    a2a = {k: rep["coll_breakdown"].get("all-to-all", 0.0)
           for k, rep in moe.items()}
    if moe and not (a2a["ep_a2a"] > 0 and a2a["sort"] == 0):
        raise RuntimeError(f"phase 17b: all-to-all bytes of dbrx-132b's "
                           f"EP and sort cells {a2a}: want some on EP and "
                           f"none on sort")
    for c in cells:
        rep, det = c["report"], c["details"]
        log(f"[dryrun] {cell_name(c)} x {rep['mesh']}: "
            f"peak {rep['peak_bytes'] / 2**30:.3f} GiB/dev, params "
            f"{det['param_bytes']} B/dev (= specs), flops "
            f"{rep['flops_dev']:.6g}, bytes {rep['bytes_dev']:.6g}, "
            f"collective bytes {rep['coll_breakdown']}, dominant "
            f"{rep['dominant']} (compute {rep['compute_s']:.6g} s, memory "
            f"{rep['memory_s']:.6g} s, collective {rep['collective_s']:.6g}"
            f" s at H100 SXM constants), useful_fraction "
            f"{rep['useful_fraction']:.4f}, kernels {det['kernels']}, "
            f"{c['wall_s']:.1f}s")
    if moe:
        ep, sort = moe["ep_a2a"], moe["sort"]
        log(f"[dryrun] dbrx-132b x {ep['shape']} on the EP path: peak "
            f"{ep['peak_bytes'] / 2**30:.3f} GiB/dev against "
            f"{sort['peak_bytes'] / 2**30:.3f} on the sort path; all-to-all "
            f"{a2a['ep_a2a']:.6g} B/dev; collective bytes "
            f"{ep['coll_dev']:.6g} against {sort['coll_dev']:.6g}")
    return cells


# ---------------------------------------------------------------------------
# Phase 18: expert parallelism (moe_block_ep's two all-to-alls)
# ---------------------------------------------------------------------------

# 18a: kimi-k2 at its published widths cut to 1 of 61 layers, on a (1, 1)
# mesh of one NCCL rank (bf16, random weights from SEED): a prefill of 32 x
# 128 and 8 greedy decode steps, both on the EP path; the gate against the
# sort path on the prefill's MoE input, its first gate_rows rows, at the
# least capacity factor from gate_cf up at which the sort path's capacity
# holds the busiest expert's pairs (EP's c_loc, ~cf^2, then holds them
# too), at most gate_max_cf (random weights route unevenly: 96 of 512
# tokens' pairs went to one expert)
EP_RUN = dict(arch="kimi-k2-1t-a32b", layers=1, batch=32, prompt=128,
              cache_len=136, steps=8, gate_rows=1, gate_cf=8.0,
              gate_max_cf=24.0)
# normwise, bf16: the two blocks sum each token's rows in one order, but
# the shared expert's products differ in shape (3-D here, 2-D there)
EP_SORT_TOL = 1e-2
# 18b: four gloo ranks on the one card, a (2, 2) mesh, dbrx-132b reduced
# (f32) at a capacity where no pair drops; each rank's full output against
# the one-process sort path (the f32 gmm tolerance)
EP_RANKS = dict(arch="dbrx-132b", shape=(2, 2), batch=4, seq=64,
                capacity_factor=8.0)
EP_RANKS_TOL = 1e-4
# a gmm launch at E 384 is held to gmm_ref this many experts at a time
# (gmm_ref's f32 copy of a whole expert matrix is 22.5 GB)
GMM_CHECK_EXPERTS = 64


def gmm_launch_errors(torch, x, w, got) -> tuple:
    """One recorded launch against gmm_ref on its own inputs, a slice of
    experts at a time: (max abs error, normwise error, share of the
    elementwise tolerance)."""
    from repro_torch.kernels.moe_gmm import gmm_ref
    tol = GMM_TOL[str(x.dtype).split(".")[-1]]
    err, ratio, num, den = 0.0, 0.0, 0.0, 0.0
    for e0 in range(0, x.shape[0], GMM_CHECK_EXPERTS):
        sl = slice(e0, e0 + GMM_CHECK_EXPERTS)
        want = gmm_ref(x[sl], w[sl]).float()
        diff = (got[sl].float() - want).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
            ratio = max(ratio, float((diff / (tol + tol * want.abs()))
                                     .max()))
        num += float((diff * diff).sum())
        den += float((want * want).sum())
        if not torch.isfinite(got[sl]).all():
            ratio = math.inf
    return err, math.sqrt(num / den) if den else 0.0, ratio


def ep_dispatch_recorder(torch, moe_mod, stages: list):
    """``_dispatch_local`` recording, on the device, each call's (buckets,
    capacity, rows, valid rows, kept rows); the script's, not the
    program's."""
    dispatch = moe_mod._dispatch_local

    def call(ids, n_buckets, capacity, valid=None):
        res = dispatch(ids, n_buckets, capacity, valid)
        n = torch.tensor(ids.numel(), device=ids.device)
        stages.append((n_buckets, capacity, n,
                       n if valid is None else valid.sum(), res[3].sum()))
        return res
    return call


def ep_drops(stages) -> dict:
    """Pairs each EP stage dropped (real rows not kept), from recorded
    dispatches, which an EP call makes in pairs: stage 1 buckets by rank,
    stage 2 by local expert."""
    out = {"send": 0, "local": 0, "c_send": [], "c_loc": []}
    for i, (buckets, cap, _, valid, kept) in enumerate(stages):
        stage = "send" if i % 2 == 0 else "local"
        out[stage] += int(valid) - int(kept)
        out["c_send" if stage == "send" else "c_loc"].append(cap)
    out["c_send"], out["c_loc"] = sorted(set(out["c_send"])), sorted(
        set(out["c_loc"]))
    return out


def sort_drops(torch, moe_mod, p, x, cfg) -> int:
    """Pairs the sort path drops on ``x`` (its routing against the
    capacity of its token count)."""
    t = x.shape[0] * x.shape[1]
    _, _, experts = moe_mod.route(p, x.reshape(t, -1), cfg)
    counts = (experts.reshape(-1, 1) == torch.arange(
        cfg.n_experts, device=x.device)).sum(0)
    return int((counts - moe_mod.expert_capacity(t, cfg)).clamp(min=0).sum())


def ep_child(out_path: str, device: str = "cuda") -> int:
    """Phase 18a, in its own process: a process group of one rank (NCCL on
    the card, gloo on the CPU), a (1, 1) ("data", "model") mesh and
    EP_RUN's model with its params as DTensors under ``axis_rules``, so
    every MoE call takes the EP path; results to ``out_path`` as JSON.
    The allocator grows its segments in place: gmm_ref's 22.5 GB f32 copy
    of an expert matrix must fit beside ~39 GB of params whose init left
    the cache fragmented."""
    import dataclasses
    import os
    import socket

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as transformer_mod
    from repro_torch.models.registry import build_model

    t = EP_RUN
    cfg = dataclasses.replace(get_config(t["arch"]), n_layers=t["layers"],
                              **t.get("cfg", {}))
    mesh = make_mesh((1, 1), ("data", "model"), dev.type)
    rules = rules_for(t["arch"], multi_pod=False, global_batch=t["batch"])
    bundle = build_model(cfg)
    out: dict = {"cfg": dict(d_model=cfg.d_model, n_experts=cfg.n_experts,
                             moe_d_ff=cfg.moe_d_ff, layers=cfg.n_layers,
                             k=cfg.experts_per_token,
                             cf=cfg.capacity_factor)}
    t0 = time.perf_counter()
    params = bundle.init(SEED, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0,
               init_peak_gb=peak_gb(torch, dev),
               n_params=sum(x.numel() for x in _tensors(params)))
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (t["batch"], t["prompt"]),
                           generator=gen).to(dev)
    launches, stages, inputs, ep_calls = [], [], [], []
    block, ep = transformer_mod.moe_block, moe_mod._moe_block_ep

    def rec_gmm(x, w):
        y = gmm(x, w)
        launches.append((x, w, y))
        return y

    def rec_block(p, x, c):
        inputs.append(x.full_tensor() if sh.is_dtensor(x) else x)
        return block(p, x, c)

    def counted_ep(*a):
        ep_calls.append(1)
        return ep(*a)
    swaps = [(moe_mod, "gmm", rec_gmm), (moe_mod, "_moe_block_ep", counted_ep),
             (moe_mod, "_dispatch_local",
              ep_dispatch_recorder(torch, moe_mod, stages)),
             (transformer_mod, "moe_block", rec_block)]

    with sh.axis_rules(rules, mesh), torch.no_grad():
        dp = sh.distribute_params(params, bundle.specs(), rules, mesh)
        toks = sh.distribute_params({"t": prompt}, {"t": ("batch", "seq")},
                                    rules, mesh)["t"]

        def prefill():
            return bundle.prefill(dp, {"tokens": toks,
                                       "cache_len": t["cache_len"]})

        def serve():
            (logits, cache), pre_ms = _timed(torch, prefill, dev)
            step_ms = []
            for _ in range(t["steps"]):
                nxt = logits.argmax(-1)[:, None]
                (logits, cache), ms = _timed(torch, lambda: bundle.decode_step(
                    dp, cache, {"tokens": nxt}), dev)
                step_ms.append(ms)
            return logits, cache, pre_ms, step_ms
        reset_counts()
        logits, cache, pre_ms, step_ms = swapped(swaps, serve)
        out.update(counts=read_counts(), paths=read_paths("moe_gmm"),
                   ep_calls=len(ep_calls), launches=len(launches),
                   prefill_ms=pre_ms, step_ms=step_ms,
                   finite=bool(torch.isfinite(sh.full_tree(logits)).all()))
        # the same calls again, warm, under the profiler
        if dev.type == "cuda":
            _, busy, kernels, wall = device_busy(torch, prefill)
            out["prefill_profile"] = dict(busy_ms=busy, kernels=kernels,
                                          wall_ms=wall)
            nxt = logits.argmax(-1)[:, None]
            _, busy, kernels, wall = device_busy(
                torch, lambda: bundle.decode_step(dp, cache,
                                                  {"tokens": nxt}))
            out["step_profile"] = dict(busy_ms=busy, kernels=kernels,
                                       wall_ms=wall)
    per_call = 2 * t["layers"]      # two dispatches a MoE layer a call
    out["drops"] = dict(
        prefill=ep_drops(stages[:per_call]),
        decode=ep_drops(stages[per_call:]),
        sort_prefill=sort_drops(torch, moe_mod, params["layers"][0]["moe"],
                                inputs[0], cfg),
        sort_decode=sum(sort_drops(torch, moe_mod,
                                   params["layers"][i % t["layers"]]["moe"],
                                   x, cfg)
                        for i, x in enumerate(inputs[t["layers"]:])),
        sort_cap_prefill=moe_mod.expert_capacity(
            t["batch"] * t["prompt"], cfg),
        sort_cap_decode=moe_mod.expert_capacity(t["batch"], cfg))

    # ---- every launch against gmm_ref on its own inputs ------------------
    errs = [gmm_launch_errors(torch, x, w, y) for x, w, y in launches]
    out["gmm"] = dict(err=max(e[0] for e in errs), rel=max(e[1] for e in errs),
                      worst=max(e[2] for e in errs),
                      shapes=sorted({(tuple(x.shape), tuple(w.shape))
                                     for x, w, _ in launches}))
    # ---- the kernel's times at E 384: one decode step's and the prefill's
    # three launches, beside gmm_ref (eager: its f32 copy of a weight is
    # 22.5 GB, too large to capture three of in a graph), bmm, the bound
    if dev.type == "cuda":
        n = 3 * t["layers"]
        for tag, sets in (("decode", launches[-n:]), ("prefill",
                                                      launches[:n])):
            torch.cuda.empty_cache()    # room for gmm_ref's f32 weight
            sets = [(x, w) for x, w, _ in sets]
            bounds = [gmm_bound_ms(x, w) for x, w in sets]
            ms = time_ms(gmm, sets)
            out[f"{tag}_gmm"] = dict(
                ms=ms, plain_ms=sum(eager_ms(gmm_ref, [s], iters=3)
                                    for s in sets) / len(sets),
                library_ms=time_ms(bmm_call, sets),
                bound_ms=sum(b for b, _ in bounds) / len(bounds),
                bound_by=max(bounds)[1],
                tflops=sum(gmm_flops(x, w) for x, w in sets) / len(sets)
                / ms / 1e9,
                shape=[list(sets[0][0].shape), list(sets[0][1].shape)])
    del launches, errs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- EP against the sort path on the same input, where neither drops
    x = inputs[0][:t["gate_rows"]].contiguous()
    n_tok = x.shape[0] * x.shape[1]
    with torch.no_grad():
        _, _, chosen = moe_mod.route(params["layers"][0]["moe"],
                                     x.reshape(n_tok, -1), cfg)
    busiest = int((chosen.reshape(-1, 1) == torch.arange(
        cfg.n_experts, device=x.device)).sum(0).max())
    cf = max(t["gate_cf"], float(math.ceil(
        busiest * cfg.n_experts / (n_tok * cfg.experts_per_token))))
    if cf > t["gate_max_cf"]:
        raise RuntimeError(f"phase 18a: the busiest expert takes {busiest} "
                           f"of {n_tok} tokens' pairs; no-drop capacity "
                           f"{cf} is past {t['gate_max_cf']}")
    gate_cfg = dataclasses.replace(cfg, capacity_factor=cf)
    gate_stages: list = []
    with sh.axis_rules(rules, mesh), torch.no_grad():
        y_ep, _ = swapped([(moe_mod, "_dispatch_local", ep_dispatch_recorder(
            torch, moe_mod, gate_stages))], moe_mod.moe_block,
            dp["layers"][0]["moe"], x, gate_cfg)
    with torch.no_grad():
        y_sort, _ = moe_mod.moe_block(params["layers"][0]["moe"], x,
                                      dataclasses.replace(gate_cfg,
                                                          moe_impl="sort"))
    d = ep_drops(gate_stages)
    out["gate"] = dict(
        rel=rel_err(y_ep, y_sort),
        err=float((y_ep.float() - y_sort.float()).abs().max()),
        tokens=n_tok, cf=cf, busiest=busiest,
        ep_drops=d["send"] + d["local"], c_send=d["c_send"],
        c_loc=d["c_loc"], sort_cap=moe_mod.expert_capacity(
            x.shape[0] * x.shape[1], gate_cfg),
        sort_drops=sort_drops(torch, moe_mod, params["layers"][0]["moe"], x,
                              gate_cfg))
    out["peak_gb"] = peak_gb(torch, dev)
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


def _ep_rank(rank: int, store: str, out_path: str, device: str) -> None:
    """One of phase 18b's gloo ranks (see ep_ranks_child): the EP block on
    its shard of x, against its shard of the one-process sort path's
    output; its result to ``out_path.<rank>``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(dev)
    world = math.prod(EP_RANKS["shape"])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from torch.distributed.tensor import Shard

    from repro_torch.configs import reduced_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import moe as moe_mod

    t = EP_RANKS
    cfg = dataclasses.replace(reduced_config(t["arch"]),
                              capacity_factor=t["capacity_factor"],
                              **t.get("cfg", {}))
    mesh = make_mesh(t["shape"], ("data", "model"), dev.type)
    # the weights whole over "data" (no FSDP split) and x placed as the EP
    # block takes it, so that the block's own collectives are the run's
    # only ones: gloo's all-gather of CUDA tensors crashes (torch 2.11)
    rules = rules_for(t["arch"], multi_pod=False, global_batch=t["batch"],
                      overrides={"embed": None})
    p = moe_mod.init_moe(torch.Generator(device=dev).manual_seed(SEED), cfg)
    x = torch.randn(t["batch"], t["seq"], cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 1))
    x_pl = [Shard(0), Shard(1)]
    stages, ep_calls = [], []
    ep = moe_mod._moe_block_ep

    def counted_ep(*a):
        ep_calls.append(1)
        return ep(*a)
    reset_counts()
    with sh.axis_rules(rules, mesh), torch.no_grad():
        dp = sh.distribute_params(p, moe_mod.moe_specs(cfg), rules, mesh)
        y, aux = swapped([(moe_mod, "_moe_block_ep", counted_ep),
                          (moe_mod, "_dispatch_local", ep_dispatch_recorder(
                              torch, moe_mod, stages))],
                         moe_mod.moe_block, dp, sh.from_full(x, mesh, x_pl),
                         cfg)
        launches = read_counts()["moe_gmm"]
        placed = list(y.placements) == x_pl
        y, aux = y.to_local(), aux.to_local()
    with torch.no_grad():
        ys, auxs = moe_mod.moe_block(p, x, dataclasses.replace(
            cfg, moe_impl="sort"))
    ys = sh.local_chunk(ys, mesh, x_pl)
    drops = ep_drops(stages)
    Path(f"{out_path}.{rank}").write_text(json.dumps(dict(
        rank=rank, ep_calls=len(ep_calls), launches=launches, placed=placed,
        err=float((y - ys).abs().max()), rel=rel_err(y, ys),
        aux_err=abs(float(aux) - float(auxs)),
        drops=drops["send"] + drops["local"], c_send=drops["c_send"],
        c_loc=drops["c_loc"])))
    dist.barrier()
    dist.destroy_process_group()


def ep_ranks_child(out_path: str, device: str = "cuda",
                   rank_fn=None) -> int:
    """Phase 18b, in its own process: EP_RANKS's four gloo ranks (NCCL
    takes one rank a device), each a process of its own on the one card,
    meeting through a file; each runs the EP block on its shard of a
    (2, 2) mesh and the one-process sort path on the same inputs.
    ``rank_fn`` (default ``_ep_rank``) is what each rank's process runs;
    the ranks' results go to ``out_path`` as one JSON list."""
    import torch.multiprocessing as mp

    world = math.prod(EP_RANKS["shape"])
    store = str(Path(out_path).resolve()) + ".rendezvous"
    try:
        mp.spawn(rank_fn or _ep_rank, args=(store, out_path, device),
                 nprocs=world)
    finally:
        Path(store).unlink(missing_ok=True)
    parts = [Path(f"{out_path}.{r}") for r in range(world)]
    Path(out_path).write_text(json.dumps(
        [json.loads(q.read_text()) for q in parts]))
    for q in parts:
        q.unlink()
    return 0


def check_ep(r: dict) -> None:
    """Phase 18a's gates on its child's result."""
    t = EP_RUN
    calls = t["layers"] * (1 + t["steps"])
    bad = {}
    if r["ep_calls"] != calls:
        bad["EP calls"] = (r["ep_calls"], calls)
    if r["counts"]["moe_gmm"] != 3 * calls or r["launches"] != 3 * calls:
        bad["gmm launches"] = (r["counts"]["moe_gmm"], r["launches"],
                               3 * calls)
    if "prefill_gmm" in r:      # the card: the path of each launch
        want = dict.fromkeys(r["paths"], 0)
        for tag, n in (("prefill", t["layers"]), ("decode",
                                                  t["layers"] * t["steps"])):
            c = r["drops"][tag]["c_loc"][0]
            want["decode" if c <= 16 else "wgmma"] += 3 * n
        if r["paths"] != want:
            bad["gmm paths"] = (r["paths"], want)
    g = r["gmm"]
    if not (g["rel"] <= GMM_NORM_TOL["bfloat16"] and g["worst"] <= 1.0):
        bad["gmm against gmm_ref"] = g
    if not r["finite"]:
        bad["logits"] = "not finite"
    gate = r["gate"]
    if gate["ep_drops"] or gate["sort_drops"]:
        bad["gate capacity"] = (f"pairs dropped at capacity {gate['cf']}: "
                                f"EP {gate['ep_drops']}, sort "
                                f"{gate['sort_drops']}")
    if not gate["rel"] <= EP_SORT_TOL:
        bad["EP against sort"] = (gate["rel"], EP_SORT_TOL)
    if bad:
        raise RuntimeError(f"phase 18a: {bad}")


def check_ep_ranks(ranks: list) -> None:
    """Phase 18b's gates: every rank took EP once with its three gmm
    launches, dropped nothing, kept x's placements, and its shard of the
    output equals the sort path's."""
    bad = [r for r in ranks if r["ep_calls"] != 1 or r["launches"] != 3
           or r["drops"] or not r["placed"] or not r["err"] <= EP_RANKS_TOL
           or not r["aux_err"] <= EP_RANKS_TOL]
    if len(ranks) != math.prod(EP_RANKS["shape"]) or bad:
        raise RuntimeError(f"phase 18b: ranks off the EP path or off the "
                           f"sort path's output: {bad or ranks}")


def phase_ep() -> dict:
    """Phase 18: kimi-k2 on the EP path on one card (18a), and four gloo
    ranks of the EP block on it (18b)."""
    t0 = time.perf_counter()
    r = _child("--phase-18a", "18a")
    t, d = EP_RUN, r["drops"]
    steps = sorted(r["step_ms"])
    log(f"[ep] {t['arch']} ({r['cfg']['layers']} layer, d_model "
        f"{r['cfg']['d_model']}, {r['cfg']['n_experts']} experts of "
        f"{r['cfg']['moe_d_ff']}, top-{r['cfg']['k']}; "
        f"{r['n_params'] / 1e9:.3f}B params) on the (1, 1) mesh: init "
        f"{r['init_s']:.1f}s, peak {r['init_peak_gb']:.2f} GB; prefill "
        f"{t['batch']} x {t['prompt']} {r['prefill_ms']:.1f} ms (cold), "
        f"{t['steps']} decode steps at batch {t['batch']}, median "
        f"{steps[len(steps) // 2]:.1f} ms; {r['ep_calls']} MoE calls all "
        f"on EP, gmm launches {r['counts']['moe_gmm']} by path "
        f"{ {k: v for k, v in r['paths'].items() if v} }; peak "
        f"{r['peak_gb']:.2f} GB")
    for tag in ("prefill", "step"):
        prof = r.get(f"{tag}_profile")
        if prof:
            log(f"[ep] warm {tag}: wall {prof['wall_ms']:.1f} ms, device "
                f"busy {prof['busy_ms']:.3f} ms over {prof['kernels']} "
                f"kernels (idle share "
                f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f})")
    log(f"[ep] pairs dropped at capacity {r['cfg']['cf']}: EP prefill "
        f"{d['prefill']['send']} at c_send {d['prefill']['c_send']} + "
        f"{d['prefill']['local']} at c_loc {d['prefill']['c_loc']}, EP "
        f"decode {d['decode']['send']} at c_send {d['decode']['c_send']} + "
        f"{d['decode']['local']} at c_loc {d['decode']['c_loc']}; the sort "
        f"path on the same inputs: prefill {d['sort_prefill']} at cap "
        f"{d['sort_cap_prefill']}, decode {d['sort_decode']} at cap "
        f"{d['sort_cap_decode']}")
    g = r["gmm"]
    log(f"[ep] every gmm launch against gmm_ref on its own inputs "
        f"({len(g['shapes'])} shapes): max_abs_err={g['err']:.3g}, "
        f"normwise {g['rel']:.3g} (tol {GMM_NORM_TOL['bfloat16']}), "
        f"{g['worst']:.3g} of the elementwise tolerance")
    for tag in ("decode", "prefill"):
        k = r.get(f"{tag}_gmm")
        if k:
            log(f"[kernel] moe_gmm at E 384, {tag} (x {k['shape'][0]}, w "
                f"{k['shape'][1]}): ms={k['ms']:.4f} ({k['tflops']:.1f} "
                f"TFLOP/s) plain_ms={k['plain_ms']:.4f} (eager) bmm_ms="
                f"{k['library_ms']:.4f} bound_ms={k['bound_ms']:.4f} "
                f"({k['bound_by']}); "
                f"{ratios(k['ms'], bound=k['bound_ms'], bmm=k['library_ms'])}")
    gate = r["gate"]
    log(f"[ep] EP against the sort path on {gate['tokens']} tokens of the "
        f"prefill's MoE input at capacity {gate['cf']} (c_send "
        f"{gate['c_send']}, c_loc {gate['c_loc']}, sort cap "
        f"{gate['sort_cap']}; the busiest expert {gate['busiest']} pairs; "
        f"pairs dropped: EP {gate['ep_drops']}, sort {gate['sort_drops']}):"
        f" normwise {gate['rel']:.3g} (tol {EP_SORT_TOL}), max abs "
        f"{gate['err']:.3g}")
    check_ep(r)
    ranks = _child("--phase-18b", "18b")
    check_ep_ranks(ranks)
    log(f"[ep] {len(ranks)} gloo ranks on a {EP_RANKS['shape']} mesh, "
        f"{EP_RANKS['arch']} reduced at capacity "
        f"{EP_RANKS['capacity_factor']}: every rank on EP with 3 gmm "
        f"launches and no pair dropped (c_send {ranks[0]['c_send']}, c_loc "
        f"{ranks[0]['c_loc']}), each rank's shard of the output against the "
        f"one-process sort path "
        f"max abs {max(x['err'] for x in ranks):.3g} (tol {EP_RANKS_TOL}), "
        f"normwise {max(x['rel'] for x in ranks):.3g}")
    log(f"[ep] phase 18 in {time.perf_counter() - t0:.1f}s")
    return dict(a=r, b=ranks)


def phase_dense_arch(torch, device: str = "cuda", reduced: bool = False,
                     arch: str = "granite-34b", n_layers: int = 0,
                     cache_len: int = 1024, lengths=(32, 700)) -> dict:
    """Phase 19 for one dense config at its published widths cut to
    ``n_layers`` (default DENSE_LAYERS[arch]): the launcher at the reduced
    size, then the first DENSE_REQUESTS of phase 4's requests through a
    dense engine and a paged one with the launch, token and logits gates;
    the burst's longest prompt prefilled alone, its logits gated and each
    of its flash launches held to the plain version; a warm decode step
    profiled.  Returns the measurements as JSON values.  The keywords let
    the flow be rehearsed on the CPU at toy size."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import EngineConfig, ServeEngine, greedy_reference

    log(f"[{arch}] launcher: repro_torch.launch.serve.main --arch {arch} "
        f"--reduced --engine --paged")
    t0 = time.perf_counter()
    launch_serve.main(["--arch", arch, "--reduced", "--engine", "--paged",
                       "--device", device, "--seed", str(SEED)])
    log(f"[{arch}] launcher done in {time.perf_counter() - t0:.1f}s")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, bundle, params = load_model(
        torch, device, reduced, arch,
        0 if reduced else n_layers or DENSE_LAYERS[arch])
    n = cfg.n_layers
    out = dict(layers=n, published_layers=get_config(arch).n_layers,
               init_s=time.perf_counter() - t0,
               init_peak_gb=peak_gb(torch, device))
    out["n_params"], out["n_bytes"] = param_size(params)
    slots, max_new = 8, 16

    def reqs():
        return burst_requests(cfg, max_new, lengths)[:DENSE_REQUESTS]
    tokens = {}
    for kind in ("dense", "paged"):
        paged = kind == "paged"
        tag = f"[{arch}{' paged' if paged else ''}]"
        engine = ServeEngine(bundle, params, EngineConfig(
            slots=slots, cache_len=cache_len, pad_to=8, max_prefill_batch=8,
            paged=paged, block_size=16), device=device)
        done, wall, counts, stats = engine_run(torch, engine, reqs)
        if len(done) != DENSE_REQUESTS or not all(
                r.done and len(r.out) == max_new and not r.oom
                for r in done):
            raise RuntimeError(f"{tag} not every request finished with its "
                               f"tokens")
        decode = "paged_decode_attention" if paged else "decode_attention"
        other = "decode_attention" if paged else "paged_decode_attention"
        check_launches(counts, {
            decode: stats["decode_steps"] * n, other: 0,
            "flash_attention": stats["prefill_calls"] * n})
        tokens[kind] = {r.rid: r.out for r in done}
        if paged:
            same = sum(tokens[kind][rid] == tokens["dense"][rid]
                       for rid in tokens[kind])
            if same != len(done):
                raise RuntimeError(f"{tag} paged engine tokens equal the "
                                   f"dense engine's for {same}/{len(done)} "
                                   f"requests, want all")
        step_kind = "paged" if paged else "slotted"
        split = split_run(torch, engine, {f"prefill_{step_kind}": "prefill",
                                          f"decode_{step_kind}": "decode"},
                          reqs())
        n_tok = sum(len(r.out) for r in done)
        log(f"{tag} engine: {len(done)} requests, max_new {max_new}, slots "
            f"{slots}, cache_len {cache_len}, pad_to 8"
            f"{', block_size 16' if paged else ''}: {n_tok} tokens in "
            f"{wall:.3f}s = {n_tok / wall:.1f} tok/s; stats {stats}; launches"
            f" {counts} ({decode} = {stats['decode_steps']} x {n}, flash = "
            f"{stats['prefill_calls']} x {n})"
            + (f"; tokens equal to the dense engine's for {same}/"
               f"{len(done)} requests" if paged else ""))

        # one mid-run decode step: kernels vs plain versions, same state
        batch = mid_run_batch(torch, engine, reqs(), device)
        step = bundle.decode_paged if paged else bundle.decode_slotted
        step_rel, drift = decode_logits_gate(torch, tag, step, params,
                                             engine, batch, LOGIT_TOL)
        step_ms = 1e3 * split["decode"][1] / max(split["decode"][0], 1)
        prof = profile_decode(torch, f"{tag}[profile]", step, params,
                              {k: v.clone() for k, v in engine.cache.items()},
                              batch, step_ms)
        out[kind] = dict(counts=counts, stats=stats, wall=wall,
                         tok_s=n_tok / wall, split=split, step_rel=step_rel,
                         step_drift=drift, step_ms=step_ms)
        if paged:
            out[kind]["same_as_dense"] = same
        if prof is not None:
            busy, by_name = prof
            out[kind].update(
                busy_ms=busy, idle_share=1 - busy / step_ms,
                kernels=sum(k for k, _ in by_name.values()) // 3,
                attention_ms=sum(t for name, (_, t) in by_name.items()
                                 if "decode_attention" in name) / 3e3)
        engine.reset()
        del engine, batch

    # greedy parity with the one-request oracle: reported, not gated
    t0 = time.perf_counter()
    oracle = sum(greedy_reference(bundle, params, r.prompt, r.max_new,
                                  cache_len, device=device)
                 == tokens["dense"][r.rid] for r in reqs())
    log(f"[{arch}] greedy tokens equal to greedy_reference: {oracle}/"
        f"{DENSE_REQUESTS} requests (reported, not gated; "
        f"{time.perf_counter() - t0:.1f}s)")

    # one prefill's first-token logits, kernels vs plain versions; the
    # flash kernel at the inputs that prefill gave it
    prompt = max((r.prompt for r in burst_requests(cfg, max_new, lengths)),
                 key=len)
    pre_rel, seen = prefill_gate(torch, bundle, params, prompt, device,
                                 f"[{arch}]", LOGIT_TOL)
    if len(seen["flash_attention"]) != n:
        raise RuntimeError(f"[{arch}] one prefill launched "
                           f"{len(seen['flash_attention'])} flash calls, "
                           f"want {n}")
    flash = flash_case_ms(torch, seen["flash_attention"])
    against = ratios(flash["ms"], bound=flash["bound_ms"],
                     sdpa=flash["library_ms"])
    log(f"[kernel] flash_attention at one {len(prompt)}-token {arch} "
        f"prefill's {n} launches (H={cfg.n_heads} KVH={cfg.n_kv_heads} hd="
        f"{cfg.resolved_head_dim}; per launch, averaged): max_abs_err="
        f"{flash['err']:.3g} normwise {flash['rel']:.3g} (tol "
        f"{FLASH_NORM_TOL[cfg.dtype]}) ms={flash['ms']:.4f} "
        f"({flash['tflops']:.1f} TFLOP/s) plain_ms={flash['plain_ms']:.4f} "
        f"sdpa_ms={flash['library_ms']:.4f} bound_ms="
        f"{flash['bound_ms']:.4f} ({flash['bound_by']}; {against})")
    out.update(requests=DENSE_REQUESTS, oracle_same=oracle,
               prefill_rel=pre_rel, flash=flash,
               prefill_drift=seen["drift"], prompt=len(prompt),
               peak_gb=peak_gb(torch, device))
    d, p = out["dense"], out["paged"]
    log(f"[{arch}] {n} of {out['published_layers']} layers: tok/s dense "
        f"{d['tok_s']:.1f}, paged {p['tok_s']:.1f}; peak device memory "
        f"{out['peak_gb']:.2f} GB")
    return out


def dense_child(arch: str, out_path: str, device: str = "cuda",
                **kw) -> int:
    """Phase 19 for ``arch`` in its own process (phase_dense_arch, its
    keywords ``kw``); results to ``out_path`` as JSON."""
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    r = phase_dense_arch(torch, device, arch=arch, **kw)
    Path(out_path).write_text(json.dumps(r))
    return 0


def phase_dense_archs() -> dict:
    """Phase 19: granite-34b and mistral-large-123b, each cut in depth and
    served in a process of its own; every gate runs in the child, which
    exits non-zero when one fails.  Returns each arch's results."""
    t0 = time.perf_counter()
    out = {}
    for arch in DENSE_LAYERS:
        r = out[arch] = _child("--phase-19", f"19 {arch}", arch, echo="")
        d, p = r["dense"], r["paged"]
        log(f"[dense] {arch}: {r['layers']} of {r['published_layers']} "
            f"layers, {r['n_params'] / 1e9:.3f}B params, "
            f"{r['n_bytes'] / 1e9:.2f} GB, init {r['init_s']:.1f}s (peak "
            f"{r['init_peak_gb']:.2f} GB), run peak {r['peak_gb']:.2f} GB; "
            f"tok/s dense {d['tok_s']:.1f}, paged {p['tok_s']:.1f}; logits "
            f"vs plain: prefill {r['prefill_rel']:.3g}, decode step "
            f"{d['step_rel']:.3g} / {p['step_rel']:.3g} (tol {LOGIT_TOL}); "
            f"paged = dense tokens {p['same_as_dense']}/{r['requests']}, "
            f"oracle {r['oracle_same']}/{r['requests']}")
    log(f"[dense] phase 19 in {time.perf_counter() - t0:.1f}s")
    return out


def dense_arch_entries(kernels: list, dense: dict) -> None:
    """Phase 19's results into the ``kernels`` line's entries: each
    arch's launches of the decode and flash kernels in its dense engine
    run and of the paged kernel in its paged run (``dense_arch_launches``),
    and the flash kernel's times at one prefill's inputs
    (``dense_arch_prefill``)."""
    by_name = {e["name"]: e for e in kernels}
    cut = ", ".join(f"{arch} ({r['layers']} of {r['published_layers']} "
                    f"layers)" for arch, r in dense.items())
    for name, run in (("decode_attention", "dense"),
                      ("paged_decode_attention", "paged"),
                      ("flash_attention", "dense")):
        entry = by_name[name]
        entry["dense_arch_launches"] = {
            arch: r[run]["counts"][name] for arch, r in dense.items()}
        entry["library"] += (f"; dense_arch_launches: phase 19's {run} "
                             f"engine runs of {cut}")
    flash = by_name["flash_attention"]
    flash["dense_arch_prefill"] = {
        arch: {"max_abs_err": r["flash"]["err"],
               "rel_err": r["flash"]["rel"],
               **{k: r["flash"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}}
        for arch, r in dense.items()}
    flash["library"] += ("; dense_arch_prefill: per launch over one "
                         "700-token prefill's launches of each")


def gmm_entry(moe, bwd=None, moe_train=None, ep=None) -> dict:
    """The ``kernels`` line's entry for the grouped matmul, from phase 12:
    launches of the dense engine's run; times per launch over one decode
    step's inputs, and (``prefill_*``) one prefill's; with phase 14's
    results, ``backward_*`` one backward at dbrx-132b's prefill shape
    (phase 14a's first case: both launches, and dX and dW apart),
    ``backward_f32_*`` its f32 case, and ``train_launches`` phase 14d's;
    with phase 18's, ``ep_launches`` (kimi-k2's EP run; ``ep_ranks_
    launches`` the four gloo ranks'), its launches' errors and ``ep_decode_
    *`` / ``ep_prefill_*`` the kernel's times at E 384."""
    d, pre = moe["paths"]["decode"], moe["paths"]["prefill"]
    entry = {
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
                   "the largest normwise error there, the gate; backward_* "
                   "GroupedMatmul's backward at E 16, C 224, D 6144, F "
                   "10752 bf16: its two launches on dY, W and X as they lie "
                   "(no transposed copies), dX = dY W^T and dW = X^T dY, "
                   "together and apart (backward_dx_*, backward_dw_*), "
                   "beside torch.bmm's two products on strided transposes; "
                   "backward_f32_* the same at E 16, C 40, D 1024, F 1536 "
                   "f32; train_launches from dbrx-132b reduced training "
                   "(phase 14d)",
    }
    for tag, r in zip(("backward", "backward_f32"), bwd or ()):
        if "ms" not in r:
            continue
        entry.update({f"{tag}_{k}": r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "dx_ms", "dw_ms", "dx_bmm_ms", "dw_bmm_ms", "dx_bound_ms",
            "dw_bound_ms")})
        entry.update({f"{tag}_max_abs_err": r["err"],
                      f"{tag}_rel_err": r["rel"]})
    if moe_train is not None:
        entry.update(train_launches=moe_train["launches"],
                     train_backward_launches=moe_train["backward_launches"])
    if ep is not None:
        a = ep["a"]
        entry.update(ep_launches=a["counts"]["moe_gmm"],
                     ep_launches_by_path=a["paths"],
                     ep_ranks_launches=sum(r["launches"] for r in ep["b"]),
                     ep_max_abs_err=a["gmm"]["err"],
                     ep_rel_err=a["gmm"]["rel"])
        for tag in ("decode", "prefill"):
            entry.update({f"ep_{tag}_{k}": a[f"{tag}_gmm"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        entry["library"] += (
            "; ep_*: kimi-k2 (1 layer, E 384, D 7168, F 2048) on the EP "
            "path, its launches over a 32 x 128 prefill and 8 decode steps, "
            "each held to gmm_ref on its own inputs; times per launch over "
            "one decode step's 3 (C 8) and the prefill's 3 (C 136), "
            "ep_*_plain_ms gmm_ref eager")
    return entry


# the wgmma kernels of the flash and gmm libraries, by the name each
# instantiation's mangled name holds: flash and the gmm forward and dX
# (wgmma_kernel), the gmm decode path (decode_kernel) and dW (dw_kernel)
WGMMA_KERNELS = ("wgmma_kernel", "gmm_decode_kernel", "gmm_dw_kernel")


def tensor_core_report(build) -> None:
    """Phase 2's check of the tensor-core kernels: each wgmma
    instantiation's registers and spills from ``-Xptxas -v`` (none may
    spill), any serialisation warning of ptxas (C7520: wgmma waits
    inserted by the compiler), and the count of wgmma instructions (HGMMA
    in the SASS) in each library."""
    for name, kinds in (("flash_attention", WGMMA_KERNELS[:1]),
                        ("moe_gmm", WGMMA_KERNELS)):
        lib = build.library_path(name)
        text = lib.with_suffix(".log").read_text()
        seen = set()
        for entry in text.split("Compiling entry function")[1:]:
            kernel = re.search(r"'(\S+?)'", entry).group(1)
            kind = next((k for k in kinds if k in kernel), None)
            if kind is None:
                continue
            seen.add(kind)
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
        per_kind, function = dict.fromkeys(kinds, 0), ""
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                function = found.group(1)
            elif "HGMMA" in line:
                for k in kinds:
                    per_kind[k] += k in function
        log(f"[build] {name}: wgmma (HGMMA) instructions in the SASS by "
            f"kernel {per_kind}; ptxas serialisation warnings: "
            f"{len(serial)}")
        if not all(per_kind.values()) or serial or seen != set(kinds):
            raise RuntimeError(f"{name}: a wgmma kernel has no HGMMA in the "
                               f"SASS ({per_kind}), or ptxas serialised it "
                               f"({serial}), or is missing from its report "
                               f"(found {sorted(seen)} of {list(kinds)})")


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
    if len(sys.argv) == 3 and sys.argv[1] == "--phase-17a":
        return mesh_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--phase-17b":
        return dryrun_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--phase-18a":
        return ep_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--phase-18b":
        return ep_ranks_child(sys.argv[2])
    if len(sys.argv) == 4 and sys.argv[1] == "--phase-19":
        return dense_child(sys.argv[2], sys.argv[3])
    t_start = time.perf_counter()
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
    flash_full = phase_flash_full_kernels(torch)
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
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    gmm_bwd = phase_gmm_backward(torch)
    train = phase_train(torch)
    moe_train = phase_moe_train(torch)
    log(f"[train] phase 14 in {time.perf_counter() - t_train:.1f}s")
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    encdec = phase_encdec(torch)
    torch.cuda.empty_cache()
    vlm = phase_vlm(torch)
    torch.cuda.empty_cache()
    log(f"[vlm] phases 15-16 in {time.perf_counter() - t_new:.1f}s")
    t_pod = time.perf_counter()
    mesh = phase_mesh()
    dry = phase_dryrun()
    log(f"[pod] phase 17 in {time.perf_counter() - t_pod:.1f}s")
    ep = phase_ep()
    torch.cuda.empty_cache()
    dense = phase_dense_archs()
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
        "encdec_launches": encdec["decode_launches"],
        "vlm_launches": vlm["decode_launches"],
        "cross_max_abs_err": encdec["cross"]["err"],
        "cross_ms": encdec["cross"]["ms"],
        "cross_plain_ms": encdec["cross"]["plain_ms"],
        "cross_bound_ms": encdec["cross"]["bound_ms"],
        "cross_bound_by": encdec["cross"]["bound_by"],
        "cross_library_ms": encdec["cross"]["library_ms"],
        "library": "scaled_dot_product_attention with the kv_len mask; "
                   "launches from qwen3-4b's dense engine run (phase 4), "
                   "times per launch over a mid-run decode step's 36; "
                   "encdec_launches and vlm_launches from phases 15-16's "
                   "decode steps; cross_* per launch over one whisper-tiny "
                   "decode step's 4 cross-attention launches (B 8, Sk "
                   "1500, 6/6 heads of 64, every row at kv_len 1500)",
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
        "eval_launches": train["eval_launches"],
        "encdec_launches": encdec["counts"]["flash_attention"],
        "encdec_launches_by_mask": encdec["masks"],
        "vlm_launches": vlm["counts"]["flash_attention"],
        "encdec_max_abs_err": encdec["flash_err"],
        "vlm_max_abs_err": vlm["flash_err"],
        **{f"{tag}_{k}": flash_full[case][k]
           for tag, case in (("full", "whisper-tiny encoder"),
                             ("cross", "whisper-tiny cross"))
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
        "full_max_abs_err": max(r["err"] for r in flash_full.values()),
        "full_max_rel_err": max(r["rel"] for r in flash_full.values()),
        "encdec_rel_err": encdec["flash_rel"],
        "vlm_rel_err": vlm["flash_rel"],
        "library": "scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True); launches from zamba2-7b's dense engine "
                   "run, times per launch averaged over one prefill's 13 "
                   "shared-block applications (hd 112); eval_launches: one "
                   "qwen2-0.5b eval step's (phase 14c); encdec_launches (by "
                   "mask: causal, full) one whisper-tiny prefill's and "
                   "vlm_launches one qwen2-vl-2b prefill's (phases 15-16); "
                   "full_* without a mask at whisper-tiny's encoder (B 8, "
                   "1500 frames, 6/6 heads of 64, bf16) and cross_* at its "
                   "prefill's cross-attention (4 queries against 1500 "
                   "keys), beside scaled_dot_product_attention("
                   "is_causal=False); full_max_abs_err and "
                   "full_max_rel_err (normwise) over phase 3c's unmasked "
                   "cases, ragged and tail ones and f32 included; "
                   "encdec_rel_err and vlm_rel_err the largest normwise "
                   "error of a prefill's launches",
    }, gmm_entry(moe, gmm_bwd, moe_train, ep)]
    dense_arch_entries(kernels, dense)
    # phase 17: launches of the (1, 1) mesh's runs, and each kernel's calls
    # in the dry run's cells (fake: no launch, extrapolated to full depth)
    mesh_launches = {
        "decode_attention": mesh["serve"]["mesh_counts"]["decode_attention"],
        "flash_attention": mesh["train"]["mesh_counts"]["flash_attention"]
        + mesh["serve"]["mesh_counts"]["flash_attention"],
        "moe_gmm": mesh["moe"]["mesh_counts"]["moe_gmm"]}
    dry_names = {"gmm": "moe_gmm"}
    for entry in kernels:
        if entry["name"] in mesh_launches:
            entry["mesh_launches"] = mesh_launches[entry["name"]]
        entry["dryrun_calls"] = {
            cell_name(c): k["calls"]
            for c in dry for name, k in c["details"]["kernels"].items()
            if dry_names.get(name, name) == entry["name"]}
    log(f"[done] phases 3-19 in {time.perf_counter() - t_total:.1f}s, the "
        f"script {time.perf_counter() - t_start:.1f}s; ecg "
        f"rates {ecg['rates']}; zamba2-7b tok/s dense "
        f"{zamba['dense']['tok_s']:.1f}, paged {zamba['paged']['tok_s']:.1f};"
        f" mamba2-780m tok/s {mamba['tok_s']:.1f}; dbrx-132b (8 layers) "
        f"tok/s dense {moe['dense']['tok_s']:.1f}, paged "
        f"{moe['paged']['tok_s']:.1f}; search {search['rates']}; "
        f"qwen2-0.5b training {train['tokens_per_s']:.0f} tokens/s over "
        f"steps 2-{TRAIN_RUN['steps'] - 1} with checkpoints "
        f"({train['run_tokens_per_s']:.0f} over "
        f"the whole run), {train['steps_per_s']:.3f} steps/s, peak "
        f"{train['peak_gb']:.2f} GB; whisper-tiny decode "
        f"{encdec['tok_s']:.1f} tok/s, training "
        f"{encdec['train']['frames_per_s']:.0f} frames/s; qwen2-vl-2b "
        f"decode {vlm['tok_s']:.1f} tok/s, training "
        f"{vlm['train']['tokens_per_s']:.0f} tokens/s, peak "
        f"{vlm['train']['peak_gb']:.2f} GB; " + "; ".join(
            f"{arch} ({r['layers']} layers) tok/s dense "
            f"{r['dense']['tok_s']:.1f}, paged {r['paged']['tok_s']:.1f}"
            for arch, r in dense.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
