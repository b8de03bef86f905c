"""Replicated serving router: health-checked dispatch, failover, load
shedding and hedged requests (DESIGN.md §14).

Counterpart of ``repro/serve/router.py``; the routing logic is the
reference's line for line, over the port's engines.  Replicas are placed
on torch devices: ``devices=None`` puts every replica on the default
device (the card) and shares one copy of the params, as the reference
does on one device; a list of devices copies the param tree to each
device a replica is pinned to (the reference's ``jax.device_put``).

A single :class:`~repro.serve.engine.ServeEngine` is a single point of
failure — one stalled or lost accelerator drops every request it holds.
:class:`ReplicaRouter` fronts N engine replicas (one per device, the
scheduler's device-affinity idiom) behind one submit/run/drain API and
adds the four behaviours an always-on deployment needs:

* **health-checked dispatch** — the router never trusts a replica's word:
  liveness is *derived from decode-step progress* (an engine with work
  whose ``decode_steps`` stops advancing is stalled, whatever it claims).
  ``heartbeat_misses`` consecutive progress-free ticks count one failure;
  ``quarantine_after`` failures — or a single injected ``device_loss`` —
  retire the replica.  The last live replica is never quarantined
  (partial progress beats none), mirroring the scheduler's device
  quarantine (core/scheduler.py).
* **failover** — requests in flight on a failed replica are re-dispatched
  to survivors *from the prompt*: greedy decode is deterministic, so the
  re-decoded output is bit-identical to the no-fault run (the chaos
  parity gate in tests/test_faults.py).  Failover requests jump the queue
  — they were admitted first, so FCFS order is preserved.
* **load shedding** — admission control rejects *explicitly* (flagged
  ``rejected``, returned unserved), never silently drops: a bounded
  router queue (``max_queue``) bounces overflow, and a request whose
  ``deadline_s`` is provably unmeetable (estimated queue wait from
  observed service times already exceeds it) is bounced up front rather
  than admitted to die.  Backpressure counts are surfaced in
  :attr:`ReplicaRouter.stats`.
* **hedged dispatch** — a request in flight longer than a seeded
  percentile of observed service times (``hedge_percentile`` over
  completions, once ``hedge_min_samples`` exist) is twinned onto a
  second replica — the speculation-twin idiom from the scheduler's
  straggler watcher.  First completion wins; the loser's slot is
  reclaimed (:meth:`ServeEngine.cancel`).

Clocks: like the engine, ``run(realtime=False)`` is a virtual clock —
one router tick = one decode step on every live replica = one second —
so every dispatch, failover, shed and hedge decision is deterministic
for tests and the bench.  ``realtime=True`` honours wall-clock arrivals.

Fault injection (seeded :class:`~repro.core.faults.FaultPlan`): the
router consults ``serve.replica`` once per live replica per tick
(``crash`` = replica loses its state and restarts, ``device_loss`` =
instant quarantine, ``stall`` = the replica silently stops progressing
for ``hang_s`` virtual seconds — only the heartbeat can notice) and
``router.dispatch`` at each hand-off (a dispatch-time ``crash`` /
``device_loss`` fails the chosen replica and requeues the request).
The router owns its clock, so it uses :meth:`FaultPlan.check`, never
``fire``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.faults import FaultPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.engine import EngineConfig, ServeEngine, ServeRequest
from repro_torch.serve.paged import blocks_for


def params_to(params: Any, device: torch.device) -> Any:
    """The param tree (dicts, lists, tensors) on ``device``; a tensor
    already there is shared, not copied."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


@dataclasses.dataclass
class RouterConfig:
    """Router knobs on top of the per-replica :class:`EngineConfig`.

    The router does all admission control itself: replicas receive work
    only when they have free capacity, so ``engine.max_queue`` should be
    left ``None`` (the router's ``max_queue`` is the one bound)."""

    replicas: int = 2
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    max_queue: Optional[int] = None   # router admission bound (explicit
    #   rejection over it); None = unbounded
    shed_deadlines: bool = True       # bounce requests whose deadline the
    #   queue-wait estimate already breaks
    heartbeat_misses: int = 3         # progress-free ticks (with work) that
    #   count one replica failure
    quarantine_after: int = 3         # failure streak that retires a replica
    hedge: bool = True                # twin stragglers onto a second replica
    hedge_percentile: float = 95.0    # straggler threshold over observed
    #   service times...
    hedge_min_samples: int = 8        # ...once this many completions exist


class _Replica:
    """One engine replica plus the router's health view of it."""

    def __init__(self, idx: int, engine: ServeEngine, device: torch.device):
        self.idx = idx
        self.engine = engine
        self.device = device
        self.live = True
        self.fail_streak = 0
        self.misses = 0            # consecutive progress-free busy ticks
        self.last_steps = 0        # decode_steps at the last heartbeat
        self.stalled_until = -1.0  # injected-stall horizon (hidden from
        #                            dispatch: only the heartbeat may react)
        self.restarts = 0

    @property
    def load(self) -> int:
        return len(self.engine.in_flight) + self.engine.queue_depth

    @property
    def free_slots(self) -> int:
        return self.engine.cfg.slots - self.load

    @property
    def free_blocks(self) -> Optional[int]:
        """Free KV-cache blocks (``None`` for dense engines).  The
        router prefers block-rich replicas and skips replicas whose pool
        cannot take a request's prompt — shedding/hedging on *block*
        depth, not just slot counts."""
        return self.engine.free_blocks


class _Flight:
    """One admitted request's dispatch state: which replicas hold a clone
    (one normally, two while hedged), and when it was first dispatched."""

    def __init__(self, req: ServeRequest, primary: int, t_dispatch: float):
        self.req = req
        self.clones: Dict[int, ServeRequest] = {}
        self.primary = primary
        self.t_dispatch = t_dispatch
        self.hedged = False


class ReplicaRouter:
    """Front N ``ServeEngine`` replicas behind one submit/run/drain API."""

    def __init__(self, bundle, params, config: Optional[RouterConfig] = None,
                 *, faults: Optional[FaultPlan] = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        cfg = config or RouterConfig()
        if cfg.replicas < 1:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.cfg = cfg
        self.faults = faults
        self.replicas: List[_Replica] = []
        for i in range(cfg.replicas):
            # device affinity: replica i pins to devices[i % len(devices)]
            # (scheduler idiom) and stages its params there; None = default
            dev = resolve_device(devices[i % len(devices)] if devices
                                 else None)
            p = params if not devices else params_to(params, dev)
            self.replicas.append(_Replica(
                i, ServeEngine(bundle, p, cfg.engine, device=dev), dev))
        self.reset()

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Fresh routing state; replica engines reset too."""
        for rep in self.replicas:
            rep.engine.reset()
            rep.live = True
            rep.fail_streak = 0
            rep.misses = 0
            rep.last_steps = 0
            rep.stalled_until = -1.0
            rep.restarts = 0
        self.queue: Deque[ServeRequest] = deque()      # admitted, undispatched
        self._requeue: Deque[ServeRequest] = deque()   # failover evictions
        #   (dispatched first: they were admitted earliest — FCFS holds)
        self.flights: Dict[int, _Flight] = {}
        self.done: List[ServeRequest] = []
        self.shed: List[ServeRequest] = []
        self._service_times: List[float] = []  # dispatch→done, completions
        self.tick_no = 0
        self.stats: Dict[str, Any] = {
            "admitted": 0, "completed": 0, "expired": 0,
            "shed_queue": 0, "shed_deadline": 0,
            "dispatches": 0, "failovers": 0, "restarts": 0,
            "hedges": 0, "hedge_wins": 0, "ticks": 0,
            "shed_blocks": 0,
            "quarantined": [],
        }
        self._min_free_blocks: Optional[int] = None

    # ------------------------------------------------------------ admission
    def _est_wait_s(self) -> Optional[float]:
        """Estimated queueing delay for a request joining the queue now:
        full service rounds ahead of it, priced at the mean observed
        service time.  ``None`` until the first completion — admit
        optimistically rather than shed on a guess."""
        if not self._service_times:
            return None
        svc = float(np.mean(self._service_times))
        slots = sum(r.engine.cfg.slots for r in self.replicas if r.live)
        backlog = len(self.queue) + len(self._requeue)
        return ((backlog + max(slots, 1) - 1) // max(slots, 1)) * svc

    def _shed(self, req: ServeRequest, now: float, why: str) -> bool:
        req.rejected = True
        req.t_done = now
        self.shed.append(req)
        self.stats[f"shed_{why}"] += 1
        return False

    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Admission control.  Returns ``False`` (request flagged
        ``rejected`` and returned by :meth:`run` unserved) when the
        bounded queue is full or the request's deadline is already
        unmeetable — explicit backpressure, never a silent drop.
        Malformed requests still raise."""
        if len(req.prompt) > self.cfg.engine.cache_len:
            raise ValueError(f"request {req.rid}: prompt length "
                             f"{len(req.prompt)} exceeds cache_len "
                             f"{self.cfg.engine.cache_len}")
        if self.cfg.engine.paged:
            pool = self.replicas[0].engine.pool
            need = pool.blocks_for(len(req.prompt))
            if need > pool.n_blocks:
                raise ValueError(f"request {req.rid}: prompt needs {need} "
                                 f"blocks but the pool only has "
                                 f"{pool.n_blocks}")
        if self.cfg.max_queue is not None \
                and len(self.queue) >= self.cfg.max_queue:
            return self._shed(req, now, "queue")
        if self.cfg.shed_deadlines and req.deadline_s is not None:
            est = self._est_wait_s()
            if est is not None and est >= req.deadline_s:
                return self._shed(req, now, "deadline")
        self.queue.append(req)
        self.stats["admitted"] += 1
        return True

    # -------------------------------------------------------------- faults
    def _check_faults(self, now: float) -> None:
        if self.faults is None:
            return
        for rep in self.replicas:
            if not rep.live:
                continue
            spec = self.faults.check("serve.replica", replica=rep.idx,
                                     tick=self.tick_no,
                                     step=rep.engine.decode_steps)
            if spec is None:
                continue
            if spec.kind == "device_loss":
                self._fail_replica(rep, lost=True)
            elif spec.kind == "crash":
                self._fail_replica(rep, lost=False)
            elif spec.kind in ("stall", "hang"):
                # silent: the replica just stops making progress; only the
                # heartbeat may notice (dispatch must not peek at this)
                rep.stalled_until = now + spec.hang_s

    # ------------------------------------------------- failure and failover
    def _fail_replica(self, rep: _Replica, *, lost: bool) -> None:
        """Handle one replica failure: evict its in-flight work for
        re-dispatch on survivors, then either quarantine the replica
        (``device_loss``, or a failure streak at ``quarantine_after``) or
        restart it.  The last live replica is never quarantined."""
        evicted: List[ServeRequest] = []
        for rid in list(self.flights):
            fl = self.flights[rid]
            if rep.idx not in fl.clones:
                continue
            del fl.clones[rep.idx]
            if not fl.clones:          # no surviving clone: full failover
                del self.flights[rid]
                evicted.append(fl.req)
                self.stats["failovers"] += 1
        # greedy decode is deterministic, so recomputing from the prompt
        # on a survivor reproduces the lost partial output bit for bit
        for req in sorted(evicted, key=lambda r: r.rid, reverse=True):
            self._requeue.appendleft(req)
        rep.engine.reset()
        rep.misses = 0
        rep.last_steps = 0
        rep.stalled_until = -1.0       # a restart clears an injected stall
        rep.fail_streak = self.cfg.quarantine_after if lost \
            else rep.fail_streak + 1
        others = [r for r in self.replicas if r.live and r is not rep]
        if rep.fail_streak >= self.cfg.quarantine_after and others:
            rep.live = False
            self.stats["quarantined"].append(rep.idx)
        else:
            rep.restarts += 1
            self.stats["restarts"] += 1

    # ------------------------------------------------------------- dispatch
    def _place(self, req: ServeRequest, rep: _Replica, now: float) -> None:
        """Hand one request to a replica as a *clone* — the original stays
        with the router so failover and hedging can re-issue it cleanly."""
        clone = ServeRequest(rid=req.rid, prompt=req.prompt,
                             max_new=req.max_new, arrival_s=req.arrival_s,
                             deadline_s=req.deadline_s)
        clone.t_arrival = req.t_arrival
        rep.engine.submit(clone)
        fl = self.flights.get(req.rid)
        if fl is None:
            fl = _Flight(req, rep.idx, now)
            self.flights[req.rid] = fl
        fl.clones[rep.idx] = clone
        self.stats["dispatches"] += 1

    def _need_blocks(self, req: ServeRequest) -> Optional[int]:
        """Blocks this request's prompt needs on a paged replica (``None``
        when the engines are dense)."""
        if not self.cfg.engine.paged:
            return None
        return blocks_for(len(req.prompt), self.cfg.engine.block_size)

    def _pick(self, exclude: Tuple[int, ...] = (),
              need_blocks: Optional[int] = None) -> Optional[_Replica]:
        """Least-loaded live replica with a free slot (ties: deepest free
        block pool, then lowest index).  When ``need_blocks`` is given,
        paged replicas whose pool cannot take the prompt right now are
        skipped — the request waits rather than being admitted to OOM.
        Health here is the *router's* view — a silently stalled replica
        still looks healthy until the heartbeat catches it."""
        cands = [r for r in self.replicas
                 if r.live and r.idx not in exclude and r.free_slots > 0]
        if need_blocks is not None:
            cands = [r for r in cands
                     if r.free_blocks is None or r.free_blocks >= need_blocks]
        if not cands:
            return None
        return min(cands, key=lambda r: (
            r.load,
            -(r.free_blocks if r.free_blocks is not None else 0),
            r.idx))

    def _dispatch(self, now: float, *, draining: bool = False) -> int:
        """Hand queued requests to replicas with free capacity — failover
        evictions first (oldest admissions), then the admission queue
        (skipped while draining).  The head request is peeked before
        placement so the pick can be block-aware; an unplaceable head
        blocks its line (FCFS, matching the engine's head-of-line
        admission)."""
        n = 0
        while True:
            src = self._requeue if self._requeue else \
                (self.queue if self.queue and not draining else None)
            if src is None:
                return n
            rep = self._pick(need_blocks=self._need_blocks(src[0]))
            if rep is None:
                return n
            req = src.popleft()
            if self.faults is not None:
                spec = self.faults.check("router.dispatch", rid=req.rid,
                                         replica=rep.idx, tick=self.tick_no)
                if spec is not None and spec.kind in ("crash",
                                                      "device_loss"):
                    # the hand-off itself surfaced the failure: requeue the
                    # request, fail the replica, try the next candidate
                    src.appendleft(req)
                    self._fail_replica(rep, lost=spec.kind == "device_loss")
                    continue
            self._place(req, rep, now)
            n += 1

    # --------------------------------------------------------------- hedge
    def _hedge(self, now: float) -> None:
        """Twin stragglers: a request in flight longer than the
        ``hedge_percentile`` of observed service times gets a second clone
        on a different replica (free capacity only — hedges never displace
        first dispatches).  First completion wins."""
        if not self.cfg.hedge \
                or len(self._service_times) < self.cfg.hedge_min_samples:
            return
        thresh = float(np.percentile(self._service_times,
                                     self.cfg.hedge_percentile))
        for fl in list(self.flights.values()):
            if fl.hedged or now - fl.t_dispatch <= thresh:
                continue
            rep = self._pick(exclude=tuple(fl.clones),
                             need_blocks=self._need_blocks(fl.req))
            if rep is None:
                continue
            self._place(fl.req, rep, now)
            fl.hedged = True
            self.stats["hedges"] += 1

    # ----------------------------------------------------- step + heartbeat
    def _step_replicas(self, now: float) -> int:
        produced = 0
        for rep in self.replicas:
            if not rep.live or now < rep.stalled_until:
                continue               # an injected stall makes no progress
            produced += int(rep.engine.tick(now)["produced"])
        if self.cfg.engine.paged:
            depth = min((r.free_blocks for r in self.replicas if r.live),
                        default=None)
            if depth is not None and (self._min_free_blocks is None
                                      or depth < self._min_free_blocks):
                self._min_free_blocks = depth
        return produced

    def _heartbeat(self, now: float) -> None:
        """Liveness from decode-step progress: a replica with work whose
        ``decode_steps`` did not advance this tick missed a heartbeat;
        ``heartbeat_misses`` in a row is a failure (evict + restart, or
        quarantine once the streak allows)."""
        for rep in self.replicas:
            if not rep.live:
                continue
            steps = rep.engine.decode_steps
            if rep.engine.has_work and steps == rep.last_steps:
                rep.misses += 1
                if rep.misses >= self.cfg.heartbeat_misses:
                    self._fail_replica(rep, lost=False)
                    continue           # _fail_replica reset the counters
            else:
                rep.misses = 0
            rep.last_steps = steps

    # ------------------------------------------------------------- collect
    def _collect(self, now: float) -> int:
        """Resolve finished clones: first completion wins, other clones are
        withdrawn (hedge loser's slot reclaimed), result copied onto the
        caller's request object."""
        n = 0
        for rep in self.replicas:
            for clone in rep.engine.take_finished():
                fl = self.flights.pop(clone.rid, None)
                if fl is None:
                    continue           # hedge twin of an already-won rid
                req = fl.req
                req.out = clone.out
                req.done = clone.done
                req.expired = clone.expired
                req.t_admit = clone.t_admit
                req.t_first = clone.t_first
                req.t_done = clone.t_done
                req.oom = clone.oom
                req.blocks_held = clone.blocks_held
                if clone.oom:
                    self.stats["shed_blocks"] += 1
                for ridx in fl.clones:
                    if ridx != rep.idx:
                        self.replicas[ridx].engine.cancel(clone.rid)
                if fl.hedged and rep.idx != fl.primary:
                    self.stats["hedge_wins"] += 1
                if clone.expired:
                    self.stats["expired"] += 1
                else:
                    self.stats["completed"] += 1
                    self._service_times.append(clone.t_done - fl.t_dispatch)
                self.done.append(req)
                n += 1
        return n

    def _expire_queued(self, now: float) -> int:
        """Expire undispatched requests whose deadline passed while they
        queued (mirrors the engine's queued-expiry semantics)."""
        n = 0
        for q in (self._requeue, self.queue):
            keep = []
            for req in q:
                if req.deadline_s is not None \
                        and now - req.t_arrival >= req.deadline_s:
                    req.expired = True
                    req.done = True
                    req.t_done = now
                    self.done.append(req)
                    self.stats["expired"] += 1
                    n += 1
                else:
                    keep.append(req)
            q.clear()
            q.extend(keep)
        return n

    # ------------------------------------------------------------------ run
    def _busy(self) -> bool:
        return bool(self.queue or self._requeue or self.flights)

    def run(self, requests: Sequence[ServeRequest], *,
            realtime: bool = False,
            log: Optional[Callable[[str], None]] = None
            ) -> List[ServeRequest]:
        """Serve a workload to completion across the replica set.

        Every submitted request comes back exactly once: completed
        (bit-identical to the single-engine greedy output, faults or not),
        ``expired`` (deadline hit) or ``rejected`` (shed explicitly at
        admission).  :attr:`stats` carries the backpressure/robustness
        summary: shed counts, failovers, restarts, hedges, quarantines."""
        self.reset()
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        t0 = time.monotonic()
        vnow = 0.0
        while pending or self._busy():
            now = (time.monotonic() - t0) if realtime else vnow
            while pending and pending[0].arrival_s <= now:
                req = pending.pop(0)
                req.t_arrival = req.arrival_s
                self.submit(req, now)
            if not realtime and not self._busy() and pending:
                vnow = pending[0].arrival_s  # idle jump to the next arrival
                continue
            self.tick_no += 1
            self._check_faults(now)
            self._expire_queued(now)
            self._dispatch(now)
            self._hedge(now)
            produced = self._step_replicas(now)
            self._heartbeat(now)
            self._collect(now)
            if not realtime:
                vnow += 1.0
            elif produced == 0 and pending and not self._busy():
                gap = pending[0].arrival_s - (time.monotonic() - t0)
                if gap > 0:
                    time.sleep(min(gap, 0.05))
            if log:
                live = sum(r.live for r in self.replicas)
                log(f"[router] t={now:7.3f}s live={live}/"
                    f"{len(self.replicas)} flights={len(self.flights)} "
                    f"queued={len(self.queue) + len(self._requeue)} "
                    f"pending={len(pending)} done={len(self.done)} "
                    f"shed={len(self.shed)}")
        self.stats["ticks"] = self.tick_no
        if self.cfg.engine.paged:
            # shed_blocks is counted at _collect (an engine reset on
            # failover wipes the engine-side counter, the router's is
            # durable); pool peaks survive resets within one run only on
            # live replicas, so take the max over all of them here.
            self.stats["min_free_blocks"] = self._min_free_blocks
            self.stats["peak_blocks_used"] = max(
                r.engine.pool.peak_used for r in self.replicas)
        return sorted(self.done + self.shed, key=lambda r: r.rid)

    # ---------------------------------------------------------------- drain
    def drain(self, *, realtime: bool = False,
              log: Optional[Callable[[str], None]] = None
              ) -> List[ServeRequest]:
        """Graceful shutdown: complete the in-flight requests (failover
        still applies — a replica dying mid-drain re-dispatches its work)
        WITHOUT admitting from the queue; undispatched requests are left
        in :attr:`queue` for the caller to reroute or fail explicitly."""
        t0 = time.monotonic()
        vnow = 0.0
        before = len(self.done)
        while self.flights or self._requeue:
            now = (time.monotonic() - t0) if realtime else vnow
            self.tick_no += 1
            self._check_faults(now)
            self._dispatch(now, draining=True)
            self._step_replicas(now)
            self._heartbeat(now)
            self._collect(now)
            if not realtime:
                vnow += 1.0
            if log:
                log(f"[router] drain t={now:7.3f}s "
                    f"flights={len(self.flights)} "
                    f"queued={len(self.queue)} (held)")
        return self.done[before:]
