"""Fault-tolerant training loop: checkpoint/restart, failure containment.

Counterpart of ``repro/training/loop.py``, with the same restart contract:

* checkpoint every ``ckpt_every`` steps (async, atomic);
* any exception inside a step (device loss, preemption, injected fault)
  rolls back to the latest complete checkpoint and replays — the data
  pipeline is (seed, step)-deterministic so replayed batches are identical;
* ``max_restarts`` bounds the retry budget.

Steps run eagerly (no ``torch.compile``) on ``device``, the card unless
told otherwise; the params are drawn from ``seed`` where the reference
takes a PRNG key.  Given a ``mesh`` (inside ``axis_rules``), the params,
the optimizer state and every batch are DTensors placed by the rules.  ``fail_injector(step)`` exists for tests: raising from
it simulates a node failure at an exact step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.shapes import ShapeCell
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (
    current_rules,
    default_rules,
    distribute_params,
    is_dtensor,
)
from repro_torch.models.registry import ModelBundle
from repro_torch.training.step import TrainState, make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_torch_ckpt"
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10


def _rules(mesh):
    return current_rules() or default_rules("pod" in mesh.mesh_dim_names)


def init_state(bundle: ModelBundle, opt, seed: int = 0,
               device: DeviceLike = None, mesh=None) -> TrainState:
    params = bundle.init(seed, resolve_device(device))
    if mesh is not None:
        params = distribute_params(params, bundle.specs(), _rules(mesh),
                                   mesh)
    return TrainState(0, params, opt.init(params))


def batch_to_device(batch: Dict[str, Any], device: torch.device,
                    bundle: Optional[ModelBundle] = None, mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """A host batch (int32 numpy tokens) as int64 tensors on ``device``;
    with a ``mesh``, DTensors placed by ``bundle``'s input axes."""
    out = {k: torch.as_tensor(v).to(device=device, dtype=torch.int64)
           for k, v in batch.items()}
    if mesh is None:
        return out
    b, s = out["labels"].shape
    _, axes = bundle.input_specs(ShapeCell("batch", "train", s, b))
    return distribute_params(out, {k: axes[k] for k in out}, _rules(mesh),
                             mesh)


def train_loop(
    bundle: ModelBundle,
    data_factory: Callable[[int], Iterator[Dict[str, Any]]],
    loop_cfg: LoopConfig,
    *,
    seed: int = 0,
    device: DeviceLike = None,
    train_step=None,
    opt=None,
    fail_injector: Optional[Callable[[int], None]] = None,
    log: Callable[[str], None] = print,
    mesh=None,
) -> Dict[str, Any]:
    """Run to ``total_steps`` with restart-on-failure.  Returns the summary
    of the reference (``state``, ``losses`` logged, ``restarts``), and
    ``loss_at`` / ``seconds_at``: each logged step's loss and wall seconds,
    a replayed step's last."""
    dev = resolve_device(device)
    if train_step is None or opt is None:
        train_step, opt = make_train_step(bundle)
    ckpt = Checkpointer(loop_cfg.ckpt_dir, keep=loop_cfg.keep)

    restarts = 0
    losses: List[float] = []
    loss_at: Dict[int, float] = {}
    seconds_at: Dict[int, float] = {}
    state = None
    while True:
        try:
            # ---- (re)start: restore latest or init fresh -----------------
            if state is None:
                state = init_state(bundle, opt, seed, dev, mesh)
                if ckpt.latest_step() is not None:
                    start, state = ckpt.restore(state)
                    log(f"[loop] restored step {start}")
                else:
                    start = 0
            else:
                start = int(state.step)

            data = data_factory(start)
            for step in range(start, loop_cfg.total_steps):
                if fail_injector is not None:
                    fail_injector(step)
                batch = batch_to_device(next(data), dev, bundle, mesh)
                t0 = time.monotonic()
                state, metrics = train_step(state, batch)
                if step % loop_cfg.log_every == 0:
                    loss = metrics["loss"]
                    if is_dtensor(loss):    # every rank: a collective
                        loss = loss.full_tensor()
                    loss = float(loss)
                    dt = time.monotonic() - t0
                    losses.append(loss)
                    loss_at[step], seconds_at[step] = loss, dt
                    log(f"[loop] step {step:5d} loss={loss:.4f} "
                        f"({dt:.2f}s)")
                if (step + 1) % loop_cfg.ckpt_every == 0:
                    ckpt.save_async(step + 1, state)
            ckpt.save(loop_cfg.total_steps, state)
            return {"state": state, "losses": losses, "restarts": restarts,
                    "loss_at": loss_at, "seconds_at": seconds_at}
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — failure containment is the point
            restarts += 1
            log(f"[loop] step failure ({type(e).__name__}: {e}); "
                f"restart {restarts}/{loop_cfg.max_restarts}")
            if restarts > loop_cfg.max_restarts:
                raise
            ckpt.wait()
            state = None  # force restore from latest checkpoint
