"""Genome front-end: a given genome -> trained, compiled, served classifier
(DESIGN.md §12).

Counterpart of ``repro/serve/winner.py``: train a genome, compile the
deployment artifact (BN-folded + quantized params, unrolling plan,
accumulator formats — core/compile_model.py), and serve batched
classification requests through one deployment-mode forward, whose convs
run through the conv kernel on the card.  ``serve_winner``, which picks
the genome from a search, waits for the search loop
(``core/evolution.py``).

The ECG winners are single-forward classifiers, so "serving" is the
prefill-only degenerate case of the engine: batches padded to a power of
two (the input length is fixed by the genome's decimation gene), no
decode loop, no cache.

:class:`ReplicatedWinner` is the classification analogue of the serving
router (DESIGN.md §14): replicas of the compiled winner's forward, batches
round-robin across live replicas, a replica that raises fails over to the
next one mid-call (same batch, same logits — the forward is
deterministic), and a failure streak quarantines the replica with the
scheduler's last-live protection.  With no ``devices`` (or one device) the
replicas share one copy of the params; a list of devices copies the
params to each (the reference's ``jax.device_put``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compile_model import CompiledModel, compile_candidate
from repro_torch.core.faults import FaultPlan, InjectedCrash
from repro_torch.core.genome import Genome
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.core.trainer import (evaluate, fit_candidate, forward,
                                      prep_inputs, to_device)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hwlib.layers import LayerSpec
from repro_torch.serve.buckets import pad_batch
from repro_torch.serve.router import params_to


@torch.no_grad()
def _deploy_forward(params: List[Dict[str, Any]], specs: List[LayerSpec],
                    x: torch.Tensor) -> torch.Tensor:
    """Deployment-mode logits: folded, quantized params; no activation
    quant; no gradient, so every conv is one fused kernel launch."""
    return forward(params, specs, x, quant=None, train=False)


def _padded(x: np.ndarray, input_length: int) -> Tuple[np.ndarray, int]:
    """Decimate to the genome's input length, then pad the batch to a
    power of two.  Returns the batch and its true size."""
    x = prep_inputs(np.asarray(x), input_length)
    b = x.shape[0]
    bp = pad_batch(b, max(b, 1))
    if bp != b:
        x = np.concatenate([x, np.zeros((bp - b,) + x.shape[1:], x.dtype)])
    return x, b


@dataclasses.dataclass
class ServableWinner:
    """A compiled winner plus its deployment forward."""

    genome: Genome
    compiled: CompiledModel
    goal: Optional[str]
    input_length: int
    train_meta: Dict[str, float]
    _predict: Any = None           # (B, L, 2) on device -> (B, n_classes)
    batches_served: int = 0
    device: Optional[torch.device] = None

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Deployment-mode logits for a batch of windows ``(B, L, 2)``.

        Inputs at the dataset's max resolution are decimated to the
        genome's input length; the batch is padded to a power of two so
        repeated serving sees a handful of shapes."""
        xp, b = _padded(x, self.input_length)
        logits = self._predict(to_device(xp, self.device))
        self.batches_served += 1
        return logits[:b].cpu().numpy()

    def classify(self, x: np.ndarray) -> np.ndarray:
        return self.predict(x).argmax(axis=1)

    def report(self) -> str:
        lines = [f"goal={self.goal} input_length={self.input_length} "
                 f"det={self.train_meta['detection_rate']:.3f} "
                 f"fa={self.train_meta['false_alarm_rate']:.3f}"]
        lines.append(self.compiled.report())
        return "\n".join(lines)


class _WinnerReplica:
    """One copy of a compiled winner's forward plus its health state."""

    def __init__(self, idx: int, predict: Any,
                 device: Optional[torch.device]):
        self.idx = idx
        self.predict = predict
        self.device = device
        self.live = True
        self.fail_streak = 0
        self.batches_served = 0


@dataclasses.dataclass
class ReplicatedWinner:
    """N copies of a :class:`ServableWinner` behind one ``predict``:
    round-robin dispatch over live replicas, mid-call failover on a raising
    replica (the forward is deterministic, so the retried batch returns
    the same logits), fail-streak quarantine with last-live protection
    (core/scheduler.py idiom)."""

    winner: ServableWinner
    replicas: List[_WinnerReplica]
    quarantine_after: int = 3
    faults: Optional[FaultPlan] = None  # "router.dispatch" inject point
    stats: Dict[str, Any] = dataclasses.field(default_factory=lambda: {
        "batches": 0, "failovers": 0, "quarantined": []})

    @property
    def input_length(self) -> int:
        return self.winner.input_length

    @property
    def live_replicas(self) -> List[int]:
        return [r.idx for r in self.replicas if r.live]

    def _fail(self, rep: _WinnerReplica) -> None:
        rep.fail_streak += 1
        others = [r for r in self.replicas if r.live and r is not rep]
        if rep.fail_streak >= self.quarantine_after and others:
            rep.live = False
            self.stats["quarantined"].append(rep.idx)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Deployment-mode logits for a batch ``(B, L, 2)``: dispatched to
        the next live replica (round-robin on batch count), failing over
        through the survivors when one raises.  Only when *every* live
        replica fails on the same batch does the error propagate."""
        xp, b = _padded(x, self.winner.input_length)
        xd = to_device(xp, self.winner.device)
        rid = self.stats["batches"]
        self.stats["batches"] += 1
        live = [r for r in self.replicas if r.live]
        order = live[rid % len(live):] + live[:rid % len(live)]
        last_err: Optional[BaseException] = None
        for i, rep in enumerate(order):
            if not rep.live:    # quarantined by an earlier lap's _fail
                continue
            try:
                if self.faults is not None:
                    spec = self.faults.check("router.dispatch", rid=rid,
                                             replica=rep.idx, tick=rid)
                    if spec is not None and spec.kind in ("crash",
                                                          "device_loss"):
                        raise InjectedCrash(
                            f"injected {spec.kind} at router.dispatch "
                            f"(replica {rep.idx})")
                logits = rep.predict(xd if rep.device is None
                                     else xd.to(rep.device))
                rep.fail_streak = 0
                rep.batches_served += 1
                return logits[:b].cpu().numpy()
            except Exception as err:  # noqa: BLE001 — any replica failure
                last_err = err
                self._fail(rep)
                if i + 1 < len(order):
                    self.stats["failovers"] += 1
        raise RuntimeError(
            f"every live replica failed batch {rid}") from last_err

    def classify(self, x: np.ndarray) -> np.ndarray:
        return self.predict(x).argmax(axis=1)

    def report(self) -> str:
        live = sum(r.live for r in self.replicas)
        return (f"replicas={live}/{len(self.replicas)} live "
                f"(quarantined={self.stats['quarantined']})\n"
                + self.winner.report())


def replicate_winner(
    winner: ServableWinner,
    replicas: int = 2,
    *,
    devices: Optional[Sequence[DeviceLike]] = None,
    space: SearchSpace = DEFAULT_SPACE,
    quarantine_after: int = 3,
    faults: Optional[FaultPlan] = None,
) -> ReplicatedWinner:
    """Put a compiled winner behind N replicas (device-affine when
    ``devices`` is given: replica i pins to ``devices[i % len]``, with the
    params copied there unless they already live there) and front them with
    round-robin + failover dispatch.  Every replica runs the same
    deployment forward on the same folded params, so replica choice never
    changes the logits."""
    if replicas < 1:
        raise ValueError("replicate_winner needs at least one replica")
    specs = winner.genome.phenotype(space)
    reps = []
    for i in range(replicas):
        dev = resolve_device(devices[i % len(devices)]) if devices else None
        p = winner.compiled.params if dev is None \
            else params_to(winner.compiled.params, dev)
        reps.append(_WinnerReplica(
            i, functools.partial(_deploy_forward, p, specs), dev))
    return ReplicatedWinner(winner=winner, replicas=reps,
                            quarantine_after=quarantine_after, faults=faults)


def compile_winner(
    genome: Genome,
    data_train: Tuple[np.ndarray, np.ndarray],
    data_val: Tuple[np.ndarray, np.ndarray],
    *,
    space: SearchSpace = DEFAULT_SPACE,
    goal: Optional[str] = None,
    train_steps: int = 300,
    train_batch: int = 64,
    seed: int = 0,
    device: DeviceLike = None,
) -> ServableWinner:
    """Train + compile one genome into a :class:`ServableWinner` on
    ``device`` (default: the card).  Trains under autograd, then
    re-estimates BN, evaluates and compiles without gradients."""
    dev = resolve_device(device)
    specs = genome.phenotype(space)
    quant = genome.quant(space)
    want_len = genome.input_length(space)
    params, x_calib = fit_candidate(
        specs, quant, prep_inputs(data_train[0], want_len), data_train[1],
        steps=train_steps, batch_size=train_batch, lr=3e-3, seed=seed,
        device=dev)
    det, fa, nll = evaluate(params, specs, quant,
                            prep_inputs(data_val[0], want_len), data_val[1],
                            device=dev)
    compiled = compile_candidate(genome, params, x_calib, space=space)
    return ServableWinner(
        genome=genome,
        compiled=compiled,
        goal=goal,
        input_length=want_len,
        train_meta={"detection_rate": det, "false_alarm_rate": fa,
                    "val_loss": nll, "steps": float(train_steps)},
        _predict=functools.partial(_deploy_forward, compiled.params, specs),
        device=dev,
    )
