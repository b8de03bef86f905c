"""Bucketed, stacked candidate training (DESIGN.md §9).

Counterpart of ``repro/core/trainer_batch.py``.  The expensive-objective
stage trains every surviving child to measure detection / false-alarm
rates.  Candidates are tiny 1D-CNNs, so a scalar ``train_candidate`` loop
pays a host dispatch per op per candidate.  Children are bucketed by
*shape signature* (the static tuple that fixes every parameter shape and
layer branch), and each bucket's per-candidate parameters are stacked on a
leading axis, so one ``torch.func.vmap`` step trains the whole bucket on
one staged dataset.

Parity contract: per-candidate results match the scalar
:func:`~repro_torch.core.trainer.train_candidate` under matched seeds.
The pieces that hold it:

* each candidate's params come from ``torch.Generator().manual_seed(seed)``
  through :func:`~repro_torch.core.trainer.init_candidate`, as in the
  scalar path, and are stacked afterwards;
* minibatch and calibration indices come from the shared
  :func:`~repro_torch.core.trainer.presample_indices` stream, staged on
  the device once;
* the step is the scalar :func:`~repro_torch.core.trainer.train_step_pure`
  term for term: the same loss (``_loss_fn``), a per-candidate
  ``clip_by_global_norm`` inside the vmap (outside it, one norm would span
  the bucket), and the same AdamW update, which is elementwise and so runs
  on the stacked leaves; the step count and its bias corrections are per
  bucket, as every member takes the same steps;
* quantization bit widths ride along as stacked per-candidate tensors (not
  part of the signature): :func:`~repro_torch.hwlib.quant.fake_quant`
  takes tensor bits, so candidates differing only in precision share one
  bucket.

BN re-estimation and evaluation take no gradient, so their convs run the
hand-written conv kernel on the card; a kernel launch cannot be vmapped,
so they run per candidate on its unstacked params, through the scalar
``refresh_bn_stats`` and ``evaluate`` (chunks of ``eval_batch`` records:
the input fake-quant scale is a per-chunk max, so chunk boundaries are part
of the numerics).  Singleton buckets take the scalar path.

Device affinity (DESIGN.md §11): ``device`` pins a call to one device
(``None`` is the card); the staged dataset is cached per ``(input_length,
device)`` and the step functions per ``(signature, steps, batch, lr,
device)``, so device-affine dispatch thrashes neither.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.genome import Genome
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.core.trainer import (
    TrainResult,
    _loss_fn,
    evaluate,
    init_candidate,
    prep_inputs,
    presample_indices,
    refresh_bn_stats,
    to_device,
    train_candidate,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hwlib.layers import LayerSpec
from repro_torch.hwlib.quant import QuantConfig
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.optim.adamw import tree_map

ShapeSignature = Tuple[Tuple[Tuple, ...], int, bool]


def shape_signature(genome: Genome, space: SearchSpace = DEFAULT_SPACE,
                    use_quant: bool = True) -> ShapeSignature:
    """The static tuple that fixes a candidate's step function: per-layer
    kernel signatures (kind, channels, kernel, stride, BN), the input
    length (decimation gene) and whether fake-quant runs at all.

    Quantization *bit widths* are deliberately absent: they enter the
    batched trainer as stacked per-candidate data, so genomes that differ
    only in precision share a signature and train in one bucket.
    """
    specs = genome.phenotype(space)
    return (tuple(s.signature() for s in specs),
            genome.input_length(space),
            bool(use_quant))


def bucket_by_signature(genomes: Sequence[Genome],
                        space: SearchSpace = DEFAULT_SPACE,
                        use_quant: bool = True
                        ) -> Dict[ShapeSignature, List[int]]:
    """Group candidate indices by :func:`shape_signature` (insertion-ordered,
    so dispatch order is deterministic given the input order)."""
    buckets: Dict[ShapeSignature, List[int]] = {}
    for i, g in enumerate(genomes):
        buckets.setdefault(shape_signature(g, space, use_quant), []).append(i)
    return buckets


# ---------------------------------------------------------------------------
# Step-function cache: one vmapped step per signature + hyperparams, as the
# reference caches one compiled pair; LRU-bounded for long-lived processes.
# ---------------------------------------------------------------------------

_CACHE_LOCK = threading.Lock()
_BUCKET_FN_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0}
_CACHE_MAX = 128


def compile_cache_stats() -> Dict[str, int]:
    with _CACHE_LOCK:
        return {**_CACHE_STATS, "size": len(_BUCKET_FN_CACHE)}


def reset_compile_cache() -> None:
    with _CACHE_LOCK:
        _BUCKET_FN_CACHE.clear()
        _CACHE_STATS.update(hits=0, misses=0)


def _build_bucket_step(specs: Sequence[LayerSpec], use_quant: bool, opt):
    """``step(params, opt_state, xb, yb, bits) -> (params, opt_state,
    loss)`` for one signature: stacked params and AdamW state, minibatches
    ``xb`` (N, B, L, C) and ``yb`` (N, B), bit widths ``bits`` (N, 3)."""

    def grads_one(params, x, y, bits):
        quant = QuantConfig(weight_bits=bits[0], act_bits=bits[1],
                            input_bits=bits[2]) if use_quant else None
        grads, loss = grad_and_value(_loss_fn)(params, specs, quant, x, y)
        grads, _ = clip_by_global_norm(grads, 1.0)
        return grads, loss

    grads_bucket = vmap(grads_one)

    def step(params, opt_state, xb, yb, bits):
        grads, loss = grads_bucket(params, xb, yb, bits)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step, opt


def _bucket_fns(sig: ShapeSignature, specs: Sequence[LayerSpec],
                steps: int, batch_size: int, lr: float,
                device: torch.device) -> tuple:
    key = (sig, steps, batch_size, float(lr), device)
    with _CACHE_LOCK:
        fns = _BUCKET_FN_CACHE.get(key)
        if fns is not None:
            _CACHE_STATS["hits"] += 1
            _BUCKET_FN_CACHE.move_to_end(key)
            return fns
        _CACHE_STATS["misses"] += 1
    opt = adamw(lr, b1=0.9, b2=0.99, weight_decay=1e-4)
    fns = _build_bucket_step(specs, use_quant=sig[2], opt=opt)
    with _CACHE_LOCK:
        fns = _BUCKET_FN_CACHE.setdefault(key, fns)
        _BUCKET_FN_CACHE.move_to_end(key)
        while len(_BUCKET_FN_CACHE) > _CACHE_MAX:
            _BUCKET_FN_CACHE.popitem(last=False)
    return fns


# ---------------------------------------------------------------------------
# Bucket training
# ---------------------------------------------------------------------------

def fit_bucket(genomes: List[Genome], seeds: Sequence[int],
               sig: ShapeSignature, space: SearchSpace,
               x_tr: torch.Tensor, y_tr: torch.Tensor, steps: int,
               batch_size: int, lr: float, device: torch.device):
    """Init and train one signature bucket, stacked: ``steps`` vmapped
    AdamW steps over each candidate's presampled minibatches.  Returns the
    stacked params and each candidate's calibration indices ``(N, C)``."""
    specs = genomes[0].phenotype(space)
    step, opt = _bucket_fns(sig, specs, steps, batch_size, lr, device)
    n = int(x_tr.shape[0])
    idx_rows, calib_rows = zip(*(presample_indices(s, n, steps, batch_size)
                                 for s in seeds))
    idx = torch.as_tensor(np.stack(idx_rows), device=device)  # (N, steps, B)
    calib = torch.as_tensor(np.stack(calib_rows), device=device)
    if sig[2]:
        bits = np.stack([(q.weight_bits, q.act_bits, q.input_bits)
                         for q in (g.quant(space) for g in genomes)])
    else:
        bits = np.zeros((len(genomes), 3))
    bits = torch.as_tensor(bits.astype(np.int32), device=device)

    per = [init_candidate(torch.Generator().manual_seed(s), specs,
                          device=device) for s in seeds]
    params = tree_map(lambda *leaves: torch.stack(leaves), *per)
    opt_state = opt.init(params)
    for s in range(steps):
        rows = idx[:, s]
        params, opt_state, _ = step(params, opt_state, x_tr[rows],
                                    y_tr[rows], bits)
    return params, calib


def _train_bucket(genomes: List[Genome], seeds: Sequence[int],
                  sig: ShapeSignature, space: SearchSpace,
                  x_tr: torch.Tensor, y_tr: torch.Tensor,
                  x_va: np.ndarray, y_va: np.ndarray,
                  steps: int, batch_size: int, lr: float,
                  eval_batch: int, device: torch.device
                  ) -> List[TrainResult]:
    specs = genomes[0].phenotype(space)
    params, calib = fit_bucket(genomes, seeds, sig, space, x_tr, y_tr,
                               steps, batch_size, lr, device)
    out = []
    for k, g in enumerate(genomes):
        quant = g.quant(space) if sig[2] else None
        mine = tree_map(lambda t: t[k], params)
        mine = refresh_bn_stats(mine, specs, x_tr[calib[k]], quant)
        det, fa, vl = evaluate(mine, specs, quant, x_va, y_va,
                               batch=eval_batch, device=device)
        if not np.isfinite(vl):
            # per-candidate quarantine (DESIGN.md §13): one diverged
            # candidate reports pessimistic rates (its argmax predictions
            # are garbage) while its bucket-mates keep their results; the
            # non-finite val_loss rides along so the search maps it
            # to the schema-pessimistic row
            det, fa = 0.0, 1.0
        out.append(TrainResult(detection_rate=det, false_alarm_rate=fa,
                               val_loss=vl, steps=steps))
    return out


def train_candidates_batched(
    genomes: Sequence[Genome],
    data_train: Tuple[np.ndarray, np.ndarray],
    data_val: Tuple[np.ndarray, np.ndarray],
    *,
    space: SearchSpace = DEFAULT_SPACE,
    steps: int = 300,
    batch_size: int = 64,
    lr: float = 3e-3,
    seed: int = 0,
    seeds: Optional[Sequence[int]] = None,
    use_quant: bool = True,
    eval_batch: int = 256,
    min_bucket: int = 2,
    stage_cache: Optional[Dict[tuple, tuple]] = None,
    device: DeviceLike = None,
) -> List[TrainResult]:
    """Train a whole child generation, bucketed by shape signature.

    Returns one :class:`TrainResult` per input genome, in input order.
    ``seeds`` optionally gives per-candidate training seeds (default: the
    single ``seed`` for all, matching the search's scalar behavior).
    Buckets smaller than ``min_bucket`` take the scalar
    :func:`train_candidate` path on the same device.  ``stage_cache``
    ((want_len, device) -> staged arrays) lets a long-lived caller keep the
    prepped training set resident on the device across calls.  ``device``
    pins every bucket of this call to one device (``None``: the card).
    """
    genomes = list(genomes)
    if seeds is None:
        seeds = [seed] * len(genomes)
    elif len(seeds) != len(genomes):
        raise ValueError("seeds must align with genomes")
    dev = resolve_device(device)
    results: List[Optional[TrainResult]] = [None] * len(genomes)
    staged = stage_cache if stage_cache is not None else {}

    def stage(want_len: int) -> tuple:
        got = staged.get((want_len, dev))
        if got is None:  # setdefault: concurrent stagers agree on one copy
            got = staged.setdefault((want_len, dev), (
                to_device(prep_inputs(data_train[0], want_len), dev),
                torch.as_tensor(data_train[1], device=dev).long(),
                prep_inputs(data_val[0], want_len),
                data_val[1]))
        return got

    for sig, rows in bucket_by_signature(genomes, space, use_quant).items():
        if len(rows) < min_bucket:
            for i in rows:
                results[i] = train_candidate(
                    genomes[i], data_train, data_val, space=space,
                    steps=steps, batch_size=batch_size, lr=lr,
                    seed=seeds[i], use_quant=use_quant, device=dev)
            continue
        x_tr, y_tr, x_va, y_va = stage(sig[1])
        bucket_results = _train_bucket(
            [genomes[i] for i in rows], [seeds[i] for i in rows], sig,
            space, x_tr, y_tr, x_va, y_va, steps, batch_size, lr,
            eval_batch, dev)
        for i, r in zip(rows, bucket_results):
            results[i] = r
    return results  # type: ignore[return-value]
