"""Continuous-batching inference engine over slot caches.

Counterpart of ``repro/serve/engine.py`` (dense slots).  Requests are
admitted into per-slot cache rows the moment a slot frees (no wave
barrier), prefill runs in padding-bucketed batches (serve/buckets.py), and
decode is ONE step over all slots per iteration — every batch row is a
slot at its own sequence position (``cache["lens"]``), so mixed prompt and
output lengths coexist in flight.  On CUDA every decode step runs the
hand-written decode-attention kernel once per layer.

The cache lives on the engine's device and is updated *in place*: prefill
rows are copied into their slots with ``index_copy_`` and decode writes
each new K/V row into the slot's cache (the reference rebuilds immutable
arrays instead).

Greedy decode through the engine matches the scalar one-request reference
(:func:`greedy_reference`) token for token: every model op on the batch
axis is row-local and both paths share the decode attention op.

Failure semantics, as the reference: ``deadline_s`` expiry reclaims the
slot and returns the partial output flagged ``expired``;
``EngineConfig.max_queue`` bounds the admission queue and a submit over it
is rejected explicitly; :meth:`ServeEngine.drain` completes in-flight work
without admitting more.  The paged cache (``EngineConfig(paged=True)``)
and the fault-injection hook raise ``NotImplementedError`` until their
slices land (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.buckets import build_buckets


@dataclasses.dataclass
class ServeRequest:
    """One inference request and its measured lifecycle."""

    rid: int
    prompt: np.ndarray             # (len,) int32
    max_new: int
    arrival_s: float = 0.0         # offset from the run's t0 (open loop)
    deadline_s: Optional[float] = None  # latency budget from arrival; the
    #   engine reclaims the slot and returns partial output on expiry
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    expired: bool = False          # deadline ran out (out = partial tokens)
    rejected: bool = False         # bounced off a full admission queue
    # measured lifecycle (seconds from the run's t0)
    t_arrival: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0           # first token emitted (prefill argmax)
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_arrival


@dataclasses.dataclass
class EngineConfig:
    slots: int = 8                 # concurrent sequences in flight
    cache_len: int = 256           # per-slot KV capacity
    pad_to: int = 8                # prompt-length bucket granularity
    max_prefill_batch: int = 8     # rows per prefill dispatch
    max_queue: Optional[int] = None  # admission-queue bound: a submit over
    #   it is rejected explicitly (backpressure).  None = unbounded
    paged: bool = False            # paged KV cache: not yet ported


class ServeEngine:
    """Slot-cache continuous batching over a ModelBundle's slotted path."""

    def __init__(self, bundle, params, config: Optional[EngineConfig] = None,
                 faults: Any = None, device: DeviceLike = None):
        cfg = config or EngineConfig()
        if faults is not None:
            raise NotImplementedError(
                "the serve.decode fault hook is not yet ported (ROADMAP.md "
                "queue 1: the fault harness moves with the router)")
        if cfg.paged:
            raise NotImplementedError(
                "EngineConfig(paged=True) is not yet ported (ROADMAP.md "
                "queue 1: the paged KV-cache slice)")
        if bundle.decode_slotted is None or bundle.prefill_slotted is None:
            raise ValueError(
                f"family {bundle.cfg.family!r} has no slotted serving path")
        if cfg.pad_to > 1 and not bundle.prefill_pads:
            raise ValueError(
                f"family {bundle.cfg.family!r} folds every prompt token "
                f"into running state — right-padded prefill buckets would "
                f"corrupt it; use pad_to=1 (exact-length buckets)")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.bundle = bundle
        self.params = params
        self.cfg = cfg
        self._specs = {k: v for k, v in bundle.cache_specs().items()
                       if k != "len"}
        self.reset()

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Fresh slot state (the cache is reallocated)."""
        cfg = self.cfg
        self.cache = self.bundle.make_slot_cache(cfg.slots, cfg.cache_len,
                                                 device=self.device)
        self.active: List[Optional[ServeRequest]] = [None] * cfg.slots
        self.last_tok = np.zeros((cfg.slots,), np.int32)
        self.waiting: List[ServeRequest] = []   # arrived, not yet admitted
        self.finished: List[ServeRequest] = []
        self.rejected: List[ServeRequest] = []  # bounced at admission
        self.decode_steps = 0
        self.prefill_calls = 0
        self.peak_concurrency = 0   # max sequences simultaneously in flight

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request.  Returns ``False`` (and flags the request
        ``rejected``) when the bounded admission queue is full.  Malformed
        requests raise."""
        if len(req.prompt) > self.cfg.cache_len:
            raise ValueError(f"request {req.rid}: prompt length "
                             f"{len(req.prompt)} exceeds cache_len "
                             f"{self.cfg.cache_len}")
        if self.cfg.max_queue is not None \
                and len(self.waiting) >= self.cfg.max_queue:
            req.rejected = True
            req.t_done = req.t_arrival
            self.rejected.append(req)
            return False
        self.waiting.append(req)
        return True

    def cancel(self, rid: int) -> Optional[ServeRequest]:
        """Withdraw a request without recording a result: an in-flight
        request's slot is reclaimed, a queued one leaves the queue.
        Returns the withdrawn request, or ``None`` when ``rid`` is not
        held here."""
        for s, r in enumerate(self.active):
            if r is not None and r.rid == rid:
                self.active[s] = None
                return r
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                return self.waiting.pop(i)
        return None

    def take_finished(self) -> List[ServeRequest]:
        """Drain the finished list (completed + expired since the last
        take)."""
        out = self.finished
        self.finished = []
        return out

    # ----------------------------------------------------- health / metrics
    @property
    def in_flight(self) -> List[ServeRequest]:
        """Requests currently occupying slots."""
        return [r for r in self.active if r is not None]

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.active)

    def stats(self) -> Dict[str, Any]:
        """Counters for reports: decode steps, prefill dispatches and peak
        sequences in flight."""
        return {
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "peak_concurrency": self.peak_concurrency,
        }

    # ------------------------------------------------------------ admission
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _splice(self, cache1: Dict[str, Any], slot_idx: np.ndarray) -> None:
        """Copy each prefill row's cache into its slot, in place.  Pad rows
        carry the out-of-range slot index ``slots``; the reference drops
        them with ``mode="drop"``.  Torch has no drop mode (an out-of-range
        index raises on the CPU and corrupts memory on CUDA), so only the
        in-range rows are selected.  Never clamp: a clamped pad row would
        overwrite a live slot."""
        keep = np.flatnonzero(slot_idx < self.cfg.slots)
        src = self._tensor(keep.astype(np.int64))
        dst = self._tensor(slot_idx[keep].astype(np.int64))
        for key, spec in self._specs.items():
            ax = spec.index("batch")
            self.cache[key].index_copy_(ax, dst,
                                        cache1[key].index_select(ax, src))
        self.cache["lens"].index_copy_(0, dst,
                                       cache1["lens"].index_select(0, src))

    def _admit(self, now: float) -> int:
        """Fill free slots from the waiting queue (FCFS), one bucketed
        prefill dispatch per padded prompt length.  Returns the number of
        requests admitted."""
        free = [s for s, r in enumerate(self.active) if r is None]
        if not free or not self.waiting:
            return 0
        take = min(len(free), len(self.waiting))
        reqs = self.waiting[:take]
        del self.waiting[:take]
        slots = free[:take]
        buckets = build_buckets([r.prompt for r in reqs], slots,
                                self.cfg.slots, pad_to=self.cfg.pad_to,
                                max_batch=self.cfg.max_prefill_batch)
        for b in buckets:
            logits, cache1 = self.bundle.prefill_slotted(
                self.params, {"tokens": self._tensor(b.tokens),
                              "lens": self._tensor(b.lens),
                              "cache_len": self.cfg.cache_len})
            self._splice(cache1, b.slot_idx)
            self.prefill_calls += 1
            first = torch.argmax(logits, dim=-1).cpu().numpy()
            for row, i in enumerate(b.rows):
                req, slot = reqs[i], slots[i]
                req.out.append(int(first[row]))
                req.t_admit = now
                req.t_first = now
                self.active[slot] = req
                self.last_tok[slot] = first[row]
                self._maybe_finish(slot, now)
        return len(reqs)

    def _finish(self, slot: int, req: ServeRequest, now: float) -> None:
        req.done = True
        req.t_done = now
        self.finished.append(req)
        self.active[slot] = None

    def _maybe_finish(self, slot: int, now: float) -> None:
        req = self.active[slot]
        seq_len = len(req.prompt) + len(req.out)
        if len(req.out) >= req.max_new or seq_len >= self.cfg.cache_len:
            self._finish(slot, req, now)

    def _expire(self, now: float) -> int:
        """Reclaim slots (and drop queued requests) whose deadline passed.
        An expired in-flight request keeps its partial output; the freed
        slot is immediately admittable.  Returns the number expired."""
        n = 0
        for s, req in enumerate(self.active):
            if req is None or req.deadline_s is None:
                continue
            if now - req.t_arrival >= req.deadline_s:
                req.expired = True
                self._finish(s, req, now)
                n += 1
        still = []
        for req in self.waiting:
            if req.deadline_s is not None \
                    and now - req.t_arrival >= req.deadline_s:
                req.expired = True
                req.done = True
                req.t_done = now
                self.finished.append(req)
                n += 1
            else:
                still.append(req)
        self.waiting = still
        return n

    # --------------------------------------------------------------- decode
    def step(self, now: float) -> int:
        """One decode step over every slot.  Returns the number of live
        tokens produced."""
        active_mask = np.array([r is not None for r in self.active])
        if not active_mask.any():
            return 0
        logits, self.cache = self.bundle.decode_slotted(
            self.params, self.cache,
            {"tokens": self._tensor(self.last_tok[:, None]),
             "active": self._tensor(active_mask)})
        self.decode_steps += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        produced = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            self.last_tok[s] = nxt[s]
            produced += 1
            self._maybe_finish(s, now)
        return produced

    # ----------------------------------------------------------------- tick
    def tick(self, now: float) -> Dict[str, float]:
        """One scheduling round on the caller's clock: expire deadlines,
        admit waiting requests (bucketed prefill), one decode step.
        Returns ``{"produced", "admitted", "expired"}`` counts."""
        expired = self._expire(now)
        admitted = self._admit(now)
        self.peak_concurrency = max(self.peak_concurrency,
                                    sum(r is not None for r in self.active))
        produced = self.step(now)
        return {"produced": produced, "admitted": admitted,
                "expired": expired}

    # ------------------------------------------------------------------ run
    def run(self, requests: Sequence[ServeRequest], *,
            realtime: bool = False,
            log: Optional[Callable[[str], None]] = None
            ) -> List[ServeRequest]:
        """Serve a workload to completion.

        ``realtime=True`` honours each request's ``arrival_s`` against the
        wall clock (open-loop load).  ``realtime=False`` runs on a virtual
        clock that ticks once per decode step — ``arrival_s`` (and
        ``deadline_s``) are then counted in decode steps, which makes
        mid-flight admission and deadline expiry deterministic for tests.

        Every submitted request comes back exactly once: completed,
        ``expired`` (deadline hit; partial output), or ``rejected``
        (bounced off a full admission queue, never served).
        """
        self.reset()
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        t0 = time.monotonic()
        clock = (lambda: time.monotonic() - t0) if realtime else None
        vnow = 0.0

        while pending or self.waiting or any(self.active):
            now = clock() if realtime else vnow
            while pending and pending[0].arrival_s <= now:
                req = pending.pop(0)
                req.t_arrival = req.arrival_s
                self.submit(req)
            if not realtime and not self.waiting and not any(self.active) \
                    and pending:
                vnow = pending[0].arrival_s  # idle jump to the next arrival
                continue
            t = self.tick(clock() if realtime else vnow)
            if not realtime:
                vnow += 1.0
            if t["produced"] == 0 and not t["admitted"] and not t["expired"]:
                if realtime and pending and not self.waiting \
                        and not any(self.active):
                    # idle gap in the open-loop schedule
                    gap = pending[0].arrival_s - (time.monotonic() - t0)
                    if gap > 0:
                        time.sleep(min(gap, 0.05))
            if log and (t["admitted"] or t["expired"]):
                log(f"[serve] t={now:7.3f}s active="
                    f"{sum(r is not None for r in self.active)} "
                    f"waiting={len(self.waiting)} pending={len(pending)} "
                    f"finished={len(self.finished)}")
        return sorted(self.finished + self.rejected, key=lambda r: r.rid)

    # ---------------------------------------------------------------- drain
    def drain(self, *, realtime: bool = False,
              log: Optional[Callable[[str], None]] = None
              ) -> List[ServeRequest]:
        """Graceful shutdown: decode the in-flight requests to completion
        WITHOUT admitting any more work.  Requests still waiting are left
        in the queue for the caller.  Returns the requests that finished
        during the drain (deadlines stay live, on the drain's own clock)."""
        t0 = time.monotonic()
        vnow = 0.0
        before = len(self.finished)
        while any(r is not None for r in self.active):
            now = (time.monotonic() - t0) if realtime else vnow
            for s, req in enumerate(self.active):
                if req is not None and req.deadline_s is not None \
                        and now - req.t_arrival >= req.deadline_s:
                    req.expired = True
                    self._finish(s, req, now)
            self.step(now)
            if not realtime:
                vnow += 1.0
            if log:
                log(f"[serve] drain t={now:7.3f}s active="
                    f"{sum(r is not None for r in self.active)} "
                    f"waiting={len(self.waiting)} (held)")
        return self.finished[before:]


# ---------------------------------------------------------------------------
# Scalar reference
# ---------------------------------------------------------------------------


def greedy_reference(bundle, params, prompt: np.ndarray, max_new: int,
                     cache_len: int, device: DeviceLike = None) -> List[int]:
    """One-request greedy decode through the *scalar* serving path
    (``bundle.prefill`` + ``bundle.decode_step`` at one shared length) —
    the engine's oracle."""
    dev = resolve_device(device)
    toks = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    logits, cache = bundle.prefill(params,
                                   {"tokens": toks, "cache_len": cache_len})
    out = [int(torch.argmax(logits[0]))]
    while len(out) < max_new and len(prompt) + len(out) < cache_len:
        tok = torch.tensor([[out[-1]]], dtype=torch.int32, device=dev)
        logits, cache = bundle.decode_step(params, cache, {"tokens": tok})
        out.append(int(torch.argmax(logits[0])))
    return out
