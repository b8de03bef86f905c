"""Expensive-objective evaluation: train a candidate, measure detection and
false-alarm rates (paper §VI: hard limits 90 % detection / 20 % false alarm).

Counterpart of ``repro/core/trainer.py``.  Candidates are small 1D-CNNs
(hwlib layers decoded from a genome) trained with AdamW on the synthetic
ECG dataset, with the genome's fake-quant config applied during training
(QAT).  Training runs under autograd; everything that takes no gradient
(BN re-estimation, evaluation) runs the convs through the conv kernel on
the card.  ``presample_indices``, ``detection_rates``, ``prep_inputs`` and
``TrainResult`` are copies of the reference's numpy code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.genome import Genome
from repro_torch.core.objective_schema import Constraints
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hwlib.layers import (DWSEP_CONV, LayerSpec, apply_layer,
                                      conv_pre_activation, init_layer)
from repro_torch.hwlib.quant import (QuantConfig, fake_quant,
                                     quantize_layer_params)
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass
class TrainResult:
    detection_rate: float
    false_alarm_rate: float
    val_loss: float
    steps: int

    def meets_constraints(self, det_min=None, fa_max=None) -> bool:
        """Paper's hard limits; accepts a
        :class:`~repro_torch.core.objective_schema.Constraints` or the
        legacy ``(det_min, fa_max)`` float pair."""
        return Constraints.coerce(det_min, fa_max).ok(
            self.detection_rate, self.false_alarm_rate)


def init_candidate(gen: torch.Generator, specs: Sequence[LayerSpec],
                   in_ch: int = 2, *, device: DeviceLike = None
                   ) -> List[Dict[str, Any]]:
    """He init of every layer from ``gen`` (drawn on the CPU, so a seed
    gives the same params on any device), placed on ``device``."""
    dev = resolve_device(device)
    params = []
    c = in_ch
    for spec in specs:
        params.append({k: v.to(dev)
                       for k, v in init_layer(gen, spec, c).items()})
        if spec.out_channels:  # convs and dense change the channel count
            c = spec.out_channels
    return params


def forward(params: Sequence[Dict[str, Any]], specs: Sequence[LayerSpec],
            x: torch.Tensor, quant: QuantConfig | None = None,
            train: bool = False) -> torch.Tensor:
    """Full candidate forward. x: (B, L, 2) -> logits (B, n_classes)."""
    h = x
    if quant is not None:
        h = fake_quant(h, quant.input_bits)
    for p, s in zip(params, specs):
        if quant is not None:
            p = quantize_layer_params(p, s, quant)
        h = apply_layer(p, s, h, train=train)
        if quant is not None and s.kind == DWSEP_CONV:
            h = fake_quant(h, quant.act_bits)
    return h


def refresh_bn_pure(params: List[Dict[str, Any]],
                    specs: Sequence[LayerSpec], x: torch.Tensor,
                    quant: QuantConfig | None = None
                    ) -> List[Dict[str, Any]]:
    """Body of :func:`refresh_bn_stats`, in the reference's order: the
    pre-BN product comes from the *quantized* weights, the stats go into
    the *unquantized* dict, and that dict is quantized again for the
    layer's forward."""
    new_params = []
    h = x
    if quant is not None:
        h = fake_quant(h, quant.input_bits)
    for p, s in zip(params, specs):
        q = quantize_layer_params(p, s, quant) if quant is not None else p
        if s.kind == DWSEP_CONV and "bn_scale" in p:
            pre = conv_pre_activation(q, s, h)
            p = dict(p)
            p["bn_mean"] = pre.mean(dim=(0, 1))
            p["bn_var"] = pre.var(dim=(0, 1), unbiased=False)
        new_params.append(p)
        q2 = quantize_layer_params(p, s, quant) if quant is not None \
            else p
        h = apply_layer(q2, s, h, train=False)
        if quant is not None and s.kind == DWSEP_CONV:
            h = fake_quant(h, quant.act_bits)
    return new_params


@torch.no_grad()
def refresh_bn_stats(params: List[Dict[str, Any]],
                     specs: Sequence[LayerSpec], x: torch.Tensor,
                     quant: QuantConfig | None = None
                     ) -> List[Dict[str, Any]]:
    """BN re-estimation: recompute each BN layer's running stats from a
    calibration batch under the *current* weights (returns a new params
    list); the stats are what batchnorm folding consumes at compile time.
    No gradient: each BN conv is two kernel launches on the card (the
    pre-BN product, then the layer's forward)."""
    return refresh_bn_pure(list(params), specs, x, quant)


def _loss_fn(params, specs, quant, x, y):
    logits = forward(params, specs, x, quant, train=True)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, y[:, None].long(), dim=1).mean()


def train_step_pure(params, opt_state, x, y, *, specs, quant, opt):
    """One AdamW step on a minibatch.  Every leaf is updated, as in the
    reference: the BN running stats get zero gradients (the training
    forward uses batch stats) but weight decay still moves them."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = _loss_fn(live, specs, quant, x, y)
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), live)
    grads, _ = clip_by_global_norm(grads, 1.0)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = apply_updates(params, updates)
    return params, opt_state, loss.detach()


def presample_indices(seed: int, n: int, steps: int, batch_size: int,
                      calib_size: int = 256
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The full ``(steps, batch_size)`` minibatch index matrix plus the BN
    calibration indices, drawn from ``default_rng(seed)`` in the exact
    stream order of the historical per-step sampling loop (numpy fills a
    ``(steps, B)`` draw row-major, so one call == ``steps`` successive
    per-step calls).  Single source of truth for the scalar AND batched
    training paths — matched seeds therefore train on matched minibatches.
    """
    nrng = np.random.default_rng(seed)
    idx = nrng.integers(0, n, (steps, batch_size))
    calib = nrng.integers(0, n, min(calib_size, n))
    return idx, calib


def detection_rates(pred: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """(detection_rate, false_alarm_rate) of hard predictions vs labels."""
    pos, neg = y == 1, y == 0
    det = float((pred[pos] == 1).mean()) if pos.any() else 0.0
    fa = float((pred[neg] == 1).mean()) if neg.any() else 1.0
    return det, fa


@torch.no_grad()
def evaluate(params, specs, quant, x: np.ndarray, y: np.ndarray,
             batch: int = 256, *, device: DeviceLike = None
             ) -> Tuple[float, float, float]:
    """(detection_rate, false_alarm_rate, mean_nll) on a dataset.

    Chunks of ``batch`` records, as in the reference: the input fake-quant
    scale is taken per chunk (DESIGN.md §9).  NLL sums and argmax
    predictions accumulate on the device; the host sees one transfer at
    the end.
    """
    dev = resolve_device(device)
    preds, nll_parts = [], []
    for i in range(0, len(x), batch):
        xb = to_device(x[i:i + batch], dev)
        yb = torch.as_tensor(y[i:i + batch], device=dev).long()
        logits = forward(params, specs, xb, quant, train=False)
        logp = torch.log_softmax(logits, dim=-1)
        nll_parts.append(-torch.take_along_dim(logp, yb[:, None],
                                               dim=1).sum())
        preds.append(logits.argmax(dim=-1))
    pred = torch.cat(preds).cpu().numpy()
    nll_sum = float(torch.stack(nll_parts).sum())
    det, fa = detection_rates(pred, y)
    return det, fa, nll_sum / len(x)


def prep_inputs(x: np.ndarray, want_len: int) -> np.ndarray:
    """Subsample max-resolution records to a genome's input length (the
    decimation gene): strided view, no copy when already at length."""
    if x.shape[1] == want_len:
        return x
    stride = x.shape[1] // want_len
    return x[:, : want_len * stride : stride]


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy batch as a contiguous f32 tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                           device=device)


def stage_training(x_tr: np.ndarray, y_tr: np.ndarray, seed: int,
                   steps: int, batch_size: int, device: torch.device):
    """The training set and the presampled ``(steps, batch)`` index matrix
    on the device once, plus the calibration batch (reference:
    ``trainer.py:236-243``): the step loop gathers minibatches on the
    device, with no host-to-device copy per step."""
    idx, calib_idx = presample_indices(seed, len(x_tr), steps, batch_size)
    x_dev = to_device(x_tr, device)
    y_dev = torch.as_tensor(y_tr, device=device).long()
    idx_dev = torch.as_tensor(idx, device=device)
    x_calib = x_dev[torch.as_tensor(calib_idx, device=device)]
    return x_dev, y_dev, idx_dev, x_calib


def fit_candidate(specs: Sequence[LayerSpec], quant: QuantConfig | None,
                  x_tr: np.ndarray, y_tr: np.ndarray, *, steps: int,
                  batch_size: int, lr: float, seed: int,
                  device: torch.device):
    """The training loop shared by :func:`train_candidate` and
    ``serve/winner.py: compile_winner``: params from
    ``torch.Generator().manual_seed(seed)``, AdamW over the presampled
    minibatches, then BN re-estimation on the calibration batch.  Returns
    ``(params, x_calib)``."""
    params = init_candidate(torch.Generator().manual_seed(seed), specs,
                            device=device)
    opt = adamw(lr, b1=0.9, b2=0.99, weight_decay=1e-4)
    opt_state = opt.init(params)
    x_dev, y_dev, idx_dev, x_calib = stage_training(x_tr, y_tr, seed, steps,
                                                    batch_size, device)
    for s in range(steps):
        params, opt_state, _ = train_step_pure(
            params, opt_state, x_dev[idx_dev[s]], y_dev[idx_dev[s]],
            specs=specs, quant=quant, opt=opt)
    # BN re-estimation on a calibration slice before deployment-mode eval
    return refresh_bn_stats(params, specs, x_calib, quant), x_calib


def train_candidate(
    genome: Genome,
    data_train: Tuple[np.ndarray, np.ndarray],
    data_val: Tuple[np.ndarray, np.ndarray],
    *,
    space: SearchSpace = DEFAULT_SPACE,
    steps: int = 300,
    batch_size: int = 64,
    lr: float = 3e-3,
    seed: int = 0,
    use_quant: bool = True,
    device: DeviceLike = None,
) -> TrainResult:
    """Train one candidate and return the expensive objectives.

    The dataset arrives at max resolution (decimation 16); the genome's
    decimation gene subsamples further if it asks for a shorter input.
    """
    dev = resolve_device(device)
    specs = genome.phenotype(space)
    quant = genome.quant(space) if use_quant else None
    want_len = genome.input_length(space)
    x_tr = prep_inputs(data_train[0], want_len)
    x_va = prep_inputs(data_val[0], want_len)
    params, _ = fit_candidate(specs, quant, x_tr, data_train[1], steps=steps,
                              batch_size=batch_size, lr=lr, seed=seed,
                              device=dev)
    det, fa, nll = evaluate(params, specs, quant, x_va, data_val[1],
                            device=dev)
    return TrainResult(detection_rate=det, false_alarm_rate=fa,
                       val_loss=nll, steps=steps)
