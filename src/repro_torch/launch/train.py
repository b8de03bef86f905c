"""Training driver.

Counterpart of ``repro/launch/train.py``: builds the model, the
(seed, step)-deterministic LM data stream and the fault-tolerant loop, and
runs it on one device, the CUDA card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --no-reduced --steps 30 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --device cpu --steps 20 --batch 8 --seq 64

The reference's mesh (``--multi-pod``, the production mesh and its
``axis_rules``) waits for the TPU-pod tooling: this driver uses one card
and no mesh.  ``--no-reduced`` (the default, as in the reference) trains
the published config; ``--reduced`` the same-family smoke config.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.data.lm import LMDataConfig, data_iterator
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.training.loop import LoopConfig, train_loop


def main(argv=None, *, fail_injector: Optional[Callable[[int], None]] = None,
         log: Callable[[str], None] = print) -> Dict[str, Any]:
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
                         "differ from repro's: keep the two apart)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="reduced config (CPU-runnable); --no-reduced "
                         "(default) trains the published config")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises "
                         "without one). One device, no mesh: the "
                         "reference's --multi-pod mesh waits for the "
                         "TPU-pod tooling")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    bundle = build_model(cfg)
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          log_every=args.log_every)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"devices=1 device={device}")
    out = train_loop(bundle, lambda s: data_iterator(data_cfg, s), loop_cfg,
                     device=device, fail_injector=fail_injector, log=log)
    print(f"done: losses {out['losses'][:2]} -> {out['losses'][-2:]} "
          f"restarts={out['restarts']}")
    return out


if __name__ == "__main__":
    main()
