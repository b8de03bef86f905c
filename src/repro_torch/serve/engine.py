"""Continuous-batching inference engine over slot caches.

Counterpart of ``repro/serve/engine.py`` (dense slots).  Requests are
admitted into per-slot cache rows the moment a slot frees (no wave
barrier), prefill runs in padding-bucketed batches (serve/buckets.py), and
decode is ONE step over all slots per iteration — every batch row is a
slot at its own sequence position (``cache["lens"]``), so mixed prompt and
output lengths coexist in flight.  On CUDA every decode step runs the
hand-written decode-attention kernel once per attention layer (once per
shared-block application for the hybrid family): the dense kernel over
slot caches, or, with ``EngineConfig(paged=True)``, the paged kernel over a
block pool.  Prefill runs the flash-attention kernel once per attention
layer and, for the SSM and hybrid families, the SSD scan kernel once per
Mamba-2 layer, on exact-length buckets (``pad_to=1``).

The cache lives on the engine's device and is updated *in place*: prefill
rows are copied into their slots (or their pool blocks) with
``index_copy_`` / ``index_put_``, and decode writes each new K/V row into
the slot's cache (the reference rebuilds immutable arrays instead).

Paged KV cache (``EngineConfig(paged=True)``, as the reference's DESIGN.md
§15): requests are admitted on free *blocks* of a shared pool
(serve/paged.py) instead of worst-case dense slots, in strict FCFS order;
each decode step first grows every active slot's table to cover its next
write, and a dry pool sheds the youngest starved admission explicitly
(``oom`` flag, partial output kept, ``shed_blocks`` counted).

Greedy decode through the engine matches the scalar one-request reference
(:func:`greedy_reference`) token for token: every model op on the batch
axis is row-local and both paths share the decode attention op.

Failure semantics, as the reference: ``deadline_s`` expiry reclaims the
slot and returns the partial output flagged ``expired``;
``EngineConfig.max_queue`` bounds the admission queue and a submit over it
is rejected explicitly; :meth:`ServeEngine.drain` completes in-flight work
without admitting more.  A :class:`~repro_torch.core.faults.FaultPlan`
given as ``faults=`` is consulted at ``serve.decode`` once a tick: a
``stall`` or ``hang`` there adds its ``hang_s`` to the caller's virtual
clock (or sleeps it, in real time).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.faults import FaultPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.buckets import build_buckets
from repro_torch.serve.paged import BlockPool
from repro_torch.trace import TRACER


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
    oom: bool = False              # shed by the paged engine when the block
    #   pool ran dry mid-decode (out = partial tokens, prefix of reference)
    blocks_held: int = 0           # peak cache blocks held (paged engine)
    # lifecycle on the caller's clock (the ``now`` it passes to ``tick``;
    # seconds from the run's t0, or decode steps on ``run``'s virtual
    # clock): t_admit and t_first are the start of the tick that ran the
    # request's prefill, not when its first token reached the host; the
    # host-clock times are the tracer's ``request.*`` events
    # (repro_torch/trace.py)
    t_arrival: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0            # the start of the tick it left in

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
    # paged KV cache: admit on free *blocks* instead of worst-case dense
    # slots.  ``n_blocks=None`` sizes the pool for the worst case (slots *
    # cache_len / block_size: never sheds); a smaller pool trades capacity
    # for memory, with explicit OOM shedding.
    paged: bool = False
    block_size: int = 16           # tokens per cache block
    n_blocks: Optional[int] = None  # pool size; None = worst case


class ServeEngine:
    """Slot-cache continuous batching over a ModelBundle's slotted path."""

    def __init__(self, bundle, params, config: Optional[EngineConfig] = None,
                 faults: Optional[FaultPlan] = None,
                 device: DeviceLike = None):
        cfg = config or EngineConfig()
        self.faults = faults  # "serve.decode" inject point
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
        self.trace_tag = TRACER.engine_tag()
        self._specs = {k: v for k, v in bundle.cache_specs().items()
                       if k != "len"}
        self.paged = cfg.paged
        self.pool: Optional[BlockPool] = None
        if cfg.paged:
            if (bundle.decode_paged is None or bundle.prefill_paged is None
                    or bundle.make_paged_cache is None):
                raise ValueError(f"family {bundle.cfg.family!r} has no "
                                 f"paged serving path")
            if cfg.cache_len % cfg.block_size:
                raise ValueError(
                    f"cache_len {cfg.cache_len} is not a multiple of "
                    f"block_size {cfg.block_size}")
            max_blocks = cfg.cache_len // cfg.block_size
            n_blocks = cfg.n_blocks or cfg.slots * max_blocks
            self.pool = BlockPool(n_blocks, cfg.block_size, cfg.slots,
                                  max_blocks)
            # pool-resident leaves are spliced block/offset-wise; per-slot
            # leaves (hybrid conv/SSM states) splice at their batch axis
            pspecs = bundle.paged_cache_specs()
            self._pool_specs = {k: v for k, v in pspecs.items()
                                if k not in ("lens", "tables")
                                and "blocks" in v}
            self._row_specs = {k: v for k, v in pspecs.items()
                               if k not in ("lens", "tables")
                               and "blocks" not in v}
            self._tables_dirty = False
        self.reset()

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Fresh slot state (the cache is reallocated)."""
        cfg = self.cfg
        if self.paged:
            self.pool.reset()
            self.cache = self.bundle.make_paged_cache(
                cfg.slots, cfg.cache_len, self.pool.n_blocks,
                cfg.block_size, device=self.device)
            self._tables_dirty = False
        else:
            self.cache = self.bundle.make_slot_cache(
                cfg.slots, cfg.cache_len, device=self.device)
        self.active: List[Optional[ServeRequest]] = [None] * cfg.slots
        self.last_tok = np.zeros((cfg.slots,), np.int32)
        self.waiting: List[ServeRequest] = []   # arrived, not yet admitted
        self.finished: List[ServeRequest] = []
        self.rejected: List[ServeRequest] = []  # bounced at admission
        self.decode_steps = 0
        self.prefill_calls = 0
        self.shed_blocks = 0        # paged OOM sheds (explicit, counted)
        self.peak_concurrency = 0   # max sequences simultaneously in flight

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request.  Returns ``False`` (and flags the request
        ``rejected``) when the bounded admission queue is full.  Malformed
        requests raise."""
        if TRACER.on:
            TRACER.event("request.submit", self.trace_tag, req.rid)
        if len(req.prompt) > self.cfg.cache_len:
            raise ValueError(f"request {req.rid}: prompt length "
                             f"{len(req.prompt)} exceeds cache_len "
                             f"{self.cfg.cache_len}")
        if self.paged:
            need = self.pool.blocks_for(len(req.prompt))
            if need > self.pool.n_blocks:
                # would never fit even an empty pool: reject explicitly
                # (truncating the prompt would silently change the output)
                raise ValueError(
                    f"request {req.rid}: prompt needs {need} cache blocks "
                    f"but the pool only has {self.pool.n_blocks}")
        if self.cfg.max_queue is not None \
                and len(self.waiting) >= self.cfg.max_queue:
            req.rejected = True
            req.t_done = req.t_arrival
            self.rejected.append(req)
            if TRACER.on:
                TRACER.event("request.done", self.trace_tag, req.rid,
                             "rejected")
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
                if self.paged:
                    self._release_blocks(s, r)
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

    @property
    def free_blocks(self) -> Optional[int]:
        """Free cache blocks in the pool (``None`` for a dense engine): the
        memory-depth signal the router's placement prefers."""
        return self.pool.free_count if self.paged else None

    def stats(self) -> Dict[str, Any]:
        """Counters for reports: decode steps, prefill dispatches, peak
        sequences in flight, OOM sheds and, for the paged engine, the
        block pool's residency."""
        d: Dict[str, Any] = {
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "peak_concurrency": self.peak_concurrency,
            "shed_blocks": self.shed_blocks,
        }
        if self.paged:
            d.update({
                "n_blocks": self.pool.n_blocks,
                "block_size": self.cfg.block_size,
                "free_blocks": self.pool.free_count,
                "peak_blocks_used": self.pool.peak_used,
            })
        return d

    # ------------------------------------------------------------ block pool
    def _release_blocks(self, slot: int, req: ServeRequest) -> None:
        """Return a leaving request's blocks to the pool (records its peak
        residency first; held counts are monotone until release)."""
        req.blocks_held = max(req.blocks_held, self.pool.held(slot))
        if self.pool.free_slot(slot):
            self._tables_dirty = True

    def _refresh_tables(self) -> bool:
        """Push the allocator's block tables to the device cache whenever
        allocation changed since the last dispatch; returns whether it
        pushed."""
        if not self._tables_dirty:
            return False
        self.cache["tables"] = self._tensor(self.pool.table_array())
        self._tables_dirty = False
        return True

    def _grow_blocks(self, now: float) -> None:
        """Pre-decode growth: every active slot needs the block covering
        its next write position.  On pool exhaustion, sheds the
        youngest-admitted starved request (explicit OOM: ``oom`` flag,
        partial output kept, a prefix of the reference, and the
        ``shed_blocks`` counter bumped; no silent drops), then retries the
        remaining starved slots with the freed blocks."""
        need = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            pos = len(req.prompt) + len(req.out) - 1  # next write position
            need.append((req.t_admit, req.rid, s, pos))
        need.sort()
        before = self.pool.allocs
        pending = need
        while True:
            failed = [item for item in pending
                      if not self.pool.ensure(item[2], item[3])]
            if not failed:
                break
            s = failed[-1][2]   # youngest admission among the starved
            self.active[s].oom = True
            self._finish(s, self.active[s], now)
            self.shed_blocks += 1
            pending = failed[:-1]
        if self.pool.allocs != before:
            self._tables_dirty = True

    # ------------------------------------------------------------ admission
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _splice_rows(self, specs: Dict[str, Any], cache1: Dict[str, Any],
                     slot_idx: np.ndarray) -> None:
        """Copy each prefill row's ``specs`` leaves and length into its
        slot, in place, at each leaf's batch axis.  Pad rows carry the
        out-of-range slot index ``slots``; the reference drops them with
        ``mode="drop"``.  Torch has no drop mode (an out-of-range index
        raises on the CPU and corrupts memory on CUDA), so only the
        in-range rows are selected.  Never clamp: a clamped pad row would
        overwrite a live slot."""
        keep = np.flatnonzero(slot_idx < self.cfg.slots)
        src = self._tensor(keep.astype(np.int64))
        dst = self._tensor(slot_idx[keep].astype(np.int64))
        for key, spec in specs.items():
            ax = spec.index("batch")
            self.cache[key].index_copy_(ax, dst,
                                        cache1[key].index_select(ax, src))
        self.cache["lens"].index_copy_(0, dst,
                                       cache1["lens"].index_select(0, src))

    def _splice(self, cache1: Dict[str, Any], slot_idx: np.ndarray) -> None:
        """Copy each prefill row's cache into its slot, in place."""
        self._splice_rows(self._specs, cache1, slot_idx)

    def _splice_paged(self, rows: Dict[str, Any], slot_idx: np.ndarray,
                      blk: np.ndarray, off: np.ndarray) -> None:
        """Scatter prefill rows into the block pool, in place: row r,
        position p goes to block ``blk[r, p]`` at offset ``off[r, p]``.
        Pad rows and pad-tail positions carry the sentinel block, which the
        reference drops with ``mode="drop"``; here they are selected away
        before ``index_put_``, as :meth:`_splice_rows` does with pad rows.
        Per-slot leaves (hybrid conv/SSM states) and the lengths go to the
        rows' slots."""
        r_idx, p_idx = np.nonzero(blk < self.pool.n_blocks)
        src = (self._tensor(r_idx), self._tensor(p_idx))
        dst = (self._tensor(blk[r_idx, p_idx].astype(np.int64)),
               self._tensor(off[r_idx, p_idx].astype(np.int64)))
        for key, spec in self._pool_specs.items():
            ax = spec.index("blocks")
            lead = (slice(None),) * ax
            self.cache[key][lead + dst] = rows[key][lead + src]
        self._splice_rows(self._row_specs, rows, slot_idx)

    def _block_offsets(self, b):
        """(B, L) block / offset index arrays for a prefill bucket: row r,
        position p lands in ``table[slot_r][p // bs]`` at offset
        ``p % bs``; pad rows and pad-tail positions get the sentinel
        block."""
        bp, L = b.tokens.shape
        bs = self.cfg.block_size
        pos = np.arange(L)
        blk = np.full((bp, L), self.pool.n_blocks, np.int32)
        off = np.tile((pos % bs).astype(np.int32), (bp, 1))
        for row in range(len(b.rows)):
            slot = int(b.slot_idx[row])
            ln = int(b.lens[row])
            table = np.asarray(self.pool.slot_blocks(slot), np.int32)
            blk[row, :ln] = table[pos[:ln] // bs]
        return blk, off

    def _take_paged(self, free: List[int]):
        """Strict-FCFS block admission: admit while *blocks* are available,
        not worst-case slots.  The first waiting request whose prompt does
        not fit blocks the line (no length-based overtaking, so paged
        admission order matches dense admission order exactly)."""
        reqs: List[ServeRequest] = []
        slots: List[int] = []
        for req in self.waiting:
            if len(reqs) >= len(free):
                break
            need = self.pool.blocks_for(len(req.prompt))
            if not self.pool.can_alloc(need):
                break
            slot = free[len(reqs)]
            self.pool.alloc(slot, need)
            reqs.append(req)
            slots.append(slot)
        del self.waiting[:len(reqs)]
        if reqs:
            self._tables_dirty = True
        return reqs, slots

    def _admit(self, now: float) -> int:
        """Fill free slots from the waiting queue (FCFS), one bucketed
        prefill dispatch per padded prompt length.  Returns the number of
        requests admitted."""
        free = [s for s, r in enumerate(self.active) if r is None]
        if not free or not self.waiting:
            return 0
        tr = TRACER if TRACER.on else None
        tag = self.trace_tag
        if tr:
            tr.open("serve.admit", tag)
        if self.paged:
            reqs, slots = self._take_paged(free)
            if not reqs:
                if tr:
                    tr.close((0,))
                return 0
        else:
            take = min(len(free), len(self.waiting))
            reqs = self.waiting[:take]
            del self.waiting[:take]
            slots = free[:take]
        buckets = build_buckets([r.prompt for r in reqs], slots,
                                self.cfg.slots, pad_to=self.cfg.pad_to,
                                max_batch=self.cfg.max_prefill_batch)
        for b in buckets:
            rids = tuple(reqs[i].rid for i in b.rows)
            if tr:
                tr.open("serve.prefill", tag)
                tr.events("request.admit", tag, rids)
                tr.open("serve.prefill.enqueue", tag)
            tokens, lens = self._tensor(b.tokens), self._tensor(b.lens)
            if self.paged:
                self._refresh_tables()
                logits, rows = self.bundle.prefill_paged(
                    self.params, {"tokens": tokens, "lens": lens})
                if tr:
                    tr.lap("serve.prefill.splice")
                self._splice_paged(rows, b.slot_idx, *self._block_offsets(b))
            else:
                logits, cache1 = self.bundle.prefill_slotted(
                    self.params, {"tokens": tokens, "lens": lens,
                                  "cache_len": self.cfg.cache_len})
                if tr:
                    tr.lap("serve.prefill.splice")
                self._splice(cache1, b.slot_idx)
            self.prefill_calls += 1
            if tr:
                tr.lap("serve.prefill.sync")
            first = torch.argmax(logits, dim=-1).cpu().numpy()
            if tr:
                tr.close()
                tr.events("request.first_token", tag, rids)
            for row, i in enumerate(b.rows):
                req, slot = reqs[i], slots[i]
                req.out.append(int(first[row]))
                req.t_admit = now
                req.t_first = now
                self.active[slot] = req
                self.last_tok[slot] = first[row]
                self._maybe_finish(slot, now)
            if tr:
                tr.close((len(rids), b.tokens.shape[1],
                          int(b.lens[:len(rids)].sum()), rids))
        if tr:
            tr.close((len(reqs),))
        return len(reqs)

    def _finish(self, slot: int, req: ServeRequest, now: float) -> None:
        """Record a leaving in-flight request and free its slot (and, when
        paged, its blocks)."""
        req.done = True
        req.t_done = now
        if TRACER.on:
            TRACER.event("request.done", self.trace_tag, req.rid,
                         "oom" if req.oom else
                         "expired" if req.expired else "")
        if self.paged:
            self._release_blocks(slot, req)
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
                if TRACER.on:
                    TRACER.event("request.done", self.trace_tag, req.rid,
                                 "expired")
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
        tr = TRACER if TRACER.on else None
        if tr:
            tr.open("serve.step", self.trace_tag)
        decode = self.bundle.decode_slotted
        if self.paged:
            # grow each active slot's table to cover this step's write
            # position; pool exhaustion sheds explicitly (OOM), so the
            # mask may shrink before the dispatch
            if tr:
                tr.open("serve.step.grow", self.trace_tag)
            self._grow_blocks(now)
            active_mask = np.array([r is not None for r in self.active])
            if not active_mask.any():
                if tr:
                    tr.close()
                    tr.close((0,))
                return 0
            if tr:
                tr.lap("serve.step.tables")
            pushed = self._refresh_tables()
            if tr:
                tr.lap("serve.step.enqueue", (pushed,))
            decode = self.bundle.decode_paged
        elif tr:
            tr.open("serve.step.enqueue", self.trace_tag)
        logits, self.cache = decode(
            self.params, self.cache,
            {"tokens": self._tensor(self.last_tok[:, None]),
             "active": self._tensor(active_mask)})
        self.decode_steps += 1
        if tr:
            tr.lap("serve.step.sync")
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        if tr:
            tr.lap("serve.step.emit")
        produced = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            self.last_tok[s] = nxt[s]
            produced += 1
            self._maybe_finish(s, now)
        if tr:
            tr.close()
            tr.close((produced,))
        return produced

    # ----------------------------------------------------------------- tick
    def tick(self, now: float, *, realtime: bool = False
             ) -> Dict[str, float]:
        """One scheduling round on the caller's clock: expire deadlines,
        admit waiting requests (bucketed prefill), one decode step.  The
        router drives its replicas through this, one round per router
        tick.

        Returns ``{"produced", "admitted", "expired", "stall_s"}``;
        ``stall_s`` is the injected ``serve.decode`` stall the caller adds
        to its virtual clock (``realtime=True`` sleeps it here)."""
        tr = TRACER if TRACER.on else None
        if tr:
            tr.open_tick(self.trace_tag)
            tr.open("serve.expire", self.trace_tag)
        expired = self._expire(now)
        if tr:
            tr.close()
        admitted = self._admit(now)
        rows = sum(r is not None for r in self.active)
        self.peak_concurrency = max(self.peak_concurrency, rows)
        stall_s = 0.0
        if self.faults is not None:
            # the engine owns no clock: the plan is consulted (check), never
            # slept inside (fire), so a virtual clock advances instead
            spec = self.faults.check("serve.decode", step=self.decode_steps)
            if spec is not None and spec.kind in ("hang", "stall"):
                if realtime:
                    time.sleep(spec.hang_s)
                else:
                    stall_s = spec.hang_s
        produced = self.step(now + stall_s)
        if tr:
            tr.close_tick((admitted, produced, expired, rows))
        return {"produced": produced, "admitted": admitted,
                "expired": expired, "stall_s": stall_s}

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
            t = self.tick(clock() if realtime else vnow, realtime=realtime)
            if not realtime:
                vnow += 1.0 + t["stall_s"]
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
