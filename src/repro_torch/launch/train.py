"""Training driver.

Counterpart of ``repro/launch/train.py``: builds the model, the
(seed, step)-deterministic LM data stream, the mesh and its sharding
rules, and the fault-tolerant loop, and runs it on the CUDA card unless
``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --no-reduced --steps 30 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --device cpu --steps 20 --batch 8 --seq 64
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-4b

The mesh is the reference's: the production mesh at 256 ranks or more
(``--multi-pod``: (2, 16, 16)), else ``(world, 1)`` over ("data",
"model"), with ``rules_for``'s rules installed around the loop.  Under
``torchrun`` (``WORLD_SIZE`` > 1) each rank joins the process group (NCCL
on the card, gloo on the CPU) on its own card, and the params, the
optimizer state and the batches are DTensors on that mesh.  With one
process there is no process group and the eager path is the one-device
path, as the reference's jit compiles a one-device sharding to nothing.
``--no-reduced`` (the default, as in the reference) trains the published
config; ``--reduced`` the same-family smoke config.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.data.lm import LMDataConfig, data_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch.mesh import make_mesh, make_production_mesh, \
    rules_for
from repro_torch.models.registry import build_model
from repro_torch.training.loop import LoopConfig, train_loop


def _line(text: str) -> None:
    """``text`` and its newline in one write: the ranks of a torchrun job
    share one stdout, and with unbuffered output (PYTHONUNBUFFERED)
    ``print`` writes the text and the newline apart, so two ranks' lines
    could run together on one line."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


def main(argv=None, *, fail_injector: Optional[Callable[[int], None]] = None,
         log: Callable[[str], None] = _line) -> Dict[str, Any]:
    """Parse ``argv``, train, print the reference's two summary lines and
    return the loop's summary.  ``fail_injector`` and ``log`` are passed
    to :func:`train_loop`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train",
                    help="checkpoint directory (the port's leaf names "
                         "are not the reference package's: keep the two "
                         "apart)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="reduced config (CPU-runnable); --no-reduced "
                         "(default) trains the published config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh at 512 ranks")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises "
                         "without one), under torchrun this rank's card")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(args.device if args.device or world == 1
                            else f"cuda:{os.environ.get('LOCAL_RANK', 0)}")
    mesh = _mesh(world, device, args.multi_pod)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    bundle = build_model(cfg)
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          log_every=args.log_every)
    rules = rules_for(args.arch, multi_pod=args.multi_pod and world >= 256,
                      global_batch=args.batch)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape)) \
        if mesh is not None else {"data": 1, "model": 1}
    _line(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"devices={world} device={device} mesh={shape}")
    with axis_rules(rules, mesh):
        out = train_loop(bundle, lambda s: data_iterator(data_cfg, s),
                         loop_cfg, device=device,
                         fail_injector=fail_injector, log=log, mesh=mesh)
    _line(f"done: losses {out['losses'][:2]} -> {out['losses'][-2:]} "
          f"restarts={out['restarts']}")
    return out


def _mesh(world: int, device: torch.device, multi_pod: bool):
    """The run's mesh: None for one process, else the process group
    (joined here under torchrun) as the production mesh at 256 ranks or
    more, else as (world, 1)."""
    if world == 1:
        return None
    dist = torch.distributed
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if world >= 256:
        return make_production_mesh(multi_pod=multi_pod,
                                    device_type=device.type)
    return make_mesh((world, 1), ("data", "model"), device.type)


if __name__ == "__main__":
    main()
