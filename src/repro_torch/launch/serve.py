"""Serving launcher: wave-batched baseline, the continuous-batching engine
and the replicated router.

Counterpart of ``repro/launch/serve.py``.  :class:`BatchedServer` is the
wave-barrier loop kept as the serving baseline: requests are packed into
waves, every slot decodes until the whole wave finishes, then the next wave
is admitted.  The production path is :class:`ServeEngine` (continuous
admission, bucketed prefill, no wave barrier), alone (``--engine``) or as
replicas behind :class:`ReplicaRouter` (``--router``); ``--paged`` gives
either a paged KV cache.  Everything runs on the card unless ``--device
cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --no-reduced --engine --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --no-reduced --router --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --no-reduced --engine --paged

The SSM and hybrid families (mamba2-780m, zamba2-7b) prefill exact-length
buckets: their states fold every prompt token, so ``pad_to`` is 1 for
them.

``--reduced`` (the default) serves the same-family smoke config;
``--no-reduced`` serves the published widths in the config's dtype.

The launcher serves token prompts through the slotted path.  It refuses
the encoder-decoder (whisper-tiny), which has none, with the reference
launcher's error, and the VLM family (qwen2-vl-2b), whose prompts are
embeddings at M-RoPE positions: the reference fails there with an
IndexError in its slotted prefill.  Both families serve through their
bundle's ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import check_token_prompts
from repro_torch.serve.engine import EngineConfig, ServeEngine, ServeRequest
from repro_torch.serve.router import ReplicaRouter, RouterConfig


class BatchedServer:
    """Wave-barrier batching over the slot-cache (prefill, decode) path.

    Admission happens only between waves (the baseline the continuous
    engine is measured against), but slot state is correct: per-slot
    lengths and per-slot masking, so a wave may mix prompt lengths."""

    def __init__(self, bundle, params, *, slots: int = 4,
                 cache_len: int = 256, device: DeviceLike = None):
        if bundle.decode_slotted is None:
            raise ValueError(f"family {bundle.cfg.family!r} has no slotted "
                             f"serving path")
        self.bundle = bundle
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.active: List[Optional[ServeRequest]] = [None] * slots
        self.cache = bundle.make_slot_cache(slots, cache_len,
                                            device=self.device)
        self._specs = {k: v for k, v in bundle.cache_specs().items()
                       if k != "len"}

    def _prefill_slot(self, slot: int, req: ServeRequest) -> None:
        """Prefill one request (batch 1, slot by slot, as the baseline
        always has) and copy its cache rows into the slot in place."""
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                               device=self.device)[None]
        lens = torch.tensor([len(req.prompt)], dtype=torch.int32,
                            device=self.device)
        logits, cache1 = self.bundle.prefill_slotted(
            self.params, {"tokens": toks, "lens": lens,
                          "cache_len": self.cache_len})
        for key, spec in self._specs.items():
            self.cache[key].select(spec.index("batch"), slot).copy_(
                cache1[key].select(spec.index("batch"), 0))
        self.cache["lens"][slot] = cache1["lens"][0]
        req.out.append(int(torch.argmax(logits[0])))

    def run(self, requests: List[ServeRequest], log=print
            ) -> List[ServeRequest]:
        pending = list(requests)
        finished: List[ServeRequest] = []
        round_no = 0
        last_tok = np.zeros((self.slots,), np.int32)
        while pending or any(self.active):
            # fill free slots with a fresh wave (barrier: only between waves)
            wave = []
            for s in range(self.slots):
                if self.active[s] is None and pending:
                    req = pending.pop(0)
                    self.active[s] = req
                    wave.append((s, req))
            for s, req in wave:
                self._prefill_slot(s, req)
                last_tok[s] = req.out[-1]
            # decode until every active request finished its budget
            while any(r is not None and not r.done for r in self.active):
                act = np.array([r is not None and not r.done
                                for r in self.active])
                logits, self.cache = self.bundle.decode_slotted(
                    self.params, self.cache,
                    {"tokens": torch.as_tensor(last_tok[:, None],
                                               device=self.device),
                     "active": torch.as_tensor(act, device=self.device)})
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
                lens = self.cache["lens"].cpu().numpy()
                for s, r in enumerate(self.active):
                    if r is None or r.done:
                        continue
                    r.out.append(int(nxt[s]))
                    last_tok[s] = nxt[s]
                    if len(r.out) >= r.max_new or \
                            int(lens[s]) >= self.cache_len:
                        r.done = True
            for s, r in enumerate(self.active):
                if r is not None and r.done:
                    finished.append(r)
                    self.active[s] = None
            round_no += 1
            log(f"[serve] round {round_no}: finished={len(finished)} "
                f"pending={len(pending)}")
        return finished


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced smoke config (default); "
                         "--no-reduced serves the published widths")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises "
                         "without one)")
    ap.add_argument("--engine", action="store_true",
                    help="use the continuous-batching ServeEngine instead "
                         "of the wave-barrier baseline")
    ap.add_argument("--router", action="store_true",
                    help="front ServeEngine replicas with the ReplicaRouter "
                         "(health checks, failover, shedding, hedging)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="replica count for --router (device-affine across "
                         "the CUDA devices when more than one is present)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: admit on free pool blocks instead "
                         "of worst-case dense slots; applies to --engine "
                         "and --router")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV-cache block for --paged")
    ap.add_argument("--blocks", type=int, default=None,
                    help="pool size in blocks for --paged (default: worst "
                         "case, slots * cache_len / block_size)")
    args = ap.parse_args(argv)
    if args.paged and not (args.engine or args.router):
        ap.error("--paged needs --engine or --router (the wave-barrier "
                 "baseline is dense-only)")

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    bundle = build_model(cfg)
    if bundle.decode_slotted is None:
        raise ValueError(f"family {cfg.family!r} has no slotted serving "
                         f"path")
    check_token_prompts(cfg)
    params = bundle.init(args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [ServeRequest(rid=i,
                         prompt=rng.integers(0, cfg.vocab_size, 12).astype(
                             np.int32),
                         max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    ecfg = EngineConfig(slots=args.slots, cache_len=64,
                        pad_to=8 if bundle.prefill_pads else 1,
                        paged=args.paged, block_size=args.block_size,
                        n_blocks=args.blocks)
    if args.router:
        devices = [device]
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        router = ReplicaRouter(bundle, params, RouterConfig(
            replicas=args.replicas, engine=ecfg), devices=devices)
        done = router.run(reqs)
        print(f"router stats: {router.stats}")
    elif args.engine:
        engine = ServeEngine(bundle, params, ecfg, device=device)
        done = engine.run(reqs)
        print(f"engine stats: {engine.stats()}")
    else:
        server = BatchedServer(bundle, params, slots=args.slots,
                               cache_len=64, device=device)
        done = server.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s) on {device} "
          f"[{cfg.name}, {cfg.dtype}]")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")


if __name__ == "__main__":
    main()
