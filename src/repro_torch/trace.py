"""Spans and counters recorded inside the port, on the host's clock.

One process-global :data:`TRACER` keeps, in fixed-size rings in memory:

* spans ``(name, t0_ns, t1_ns, parent, engine, attrs)``: ``t0_ns`` and
  ``t1_ns`` from ``time.perf_counter_ns()``, ``parent`` the index of the
  span that was open when this one opened (-1 for none), ``engine`` the
  tag of the :class:`~repro_torch.serve.engine.ServeEngine` that recorded
  it (a router's replicas each have their own), ``attrs`` a small tuple;
* request events ``(name, t_ns, engine, rid, note)`` in the same ring;
* MoE entries ``(counts, cap, tokens, parent)`` in a ring of their own:
  a reference to the per-expert pair counts that
  :func:`repro_torch.models.moe._moe_block` already computes (a device
  tensor), the call's capacity and its token count, as host ints, and
  the span open at the call.  The four are kept in four lists, so that a
  stash makes no new object for Python's garbage collector to track
  beside the tensor itself.

Each record has an index, its place in the order of recording; the ring
holds the newest ``capacity`` of them and overwrites the oldest.  Nothing
is written out, and recording never syncs the device or launches a kernel:
a reader takes :meth:`Tracer.snapshot` once the measured work is over and
copies the MoE counts to the host then, in one copy
(:func:`moe_counts`).

``serve.tick`` spans carry ``time.time_ns()`` read next to their ``t0``
as their first attr: the pair maps every span under that tick onto the
epoch's clock, which ``torch.profiler`` reports device activity in
(:meth:`Snapshot.epoch_offset`).  The mapping is taken per tick, so the
two clocks may drift apart over a run.

The engine records (``serve/engine.py``):

``serve.tick``
    attrs ``(wall_ns, admitted, produced, expired, rows active)``;
    children ``serve.expire``, ``serve.admit`` (ticks that had a free slot
    and a waiting request; attrs ``(admitted,)``) and ``serve.step``.
``serve.prefill``
    one per prefill bucket, under ``serve.admit``; attrs ``(rows, padded
    length, prompt tokens, rids)``; children ``serve.prefill.enqueue``
    (the inputs' copies and the bundle's prefill call), ``.splice`` (the
    rows into their slots or pool blocks) and ``.sync`` (the argmax and
    its copy to the host).
``serve.step``
    attrs ``(produced,)``; children ``serve.step.grow`` (the block tables
    grown to the next write), ``.tables`` (attrs ``(pushed,)``: whether
    the tables were copied to the device), ``.enqueue`` (the bundle's
    decode call), ``.sync`` (the argmax and its copy to the host) and
    ``.emit`` (the loop over the slots).
``model.decode.graph``
    one per call of the LM bundle's ``decode_paged``
    (``models/decode_graph.py``), under ``serve.step.enqueue``, recorded
    when the call returns (:meth:`Tracer.record`, so that the MoE entries
    the call makes keep ``serve.step.enqueue`` as their parent); attrs
    ``(mode, captures so far)``, mode ``replay``, ``capture`` (the eager
    step, then its capture) or ``eager``.
``model.glue``
    one per call of an LM bundle's ``prefill_paged`` (under
    ``serve.prefill.enqueue``) and ``decode_paged`` (beside
    ``model.decode.graph``), recorded as it returns; attrs ``(fused,
    torch)``, the glue sites of the call that ran the fused kernels and
    PyTorch's ops (``models/glue.py``; a replay counts its capture's).
``request.*``
    ``submit``, ``admit``, ``first_token`` and ``done``, events with the
    request's rid: ``admit`` at the start of its prefill bucket,
    ``first_token`` once that bucket's argmax is on the host, ``done``
    with the note ``oom``, ``expired`` or ``rejected`` where the request
    did not complete.

Only one thread records: the open spans are one stack.  Recording is on
by default; :meth:`Tracer.disable` leaves each site one attribute test.
Measured cost on an H100 machine's host, and what a decode tick records,
are in ``PERF.md``.

Memory, once full: the span ring, ``1 << 17`` records of about 170 B
each (the slot, the tuple and its ints), 21 MiB of host memory; the MoE
ring, ``1 << 16`` entries of about 450 B of host objects each (the
tensor's Python and C++ objects), 28 MiB, and on the device each entry's
counts tensor, at 16 experts 128 B in a 512 B block of the caching
allocator, 32 MiB.  At the rate of one H100 serving 64 chat slots of an
8-layer dbrx-132b (about 270 records and 270 MoE entries a second) the
span ring holds the last 8 minutes and the MoE ring the last 4.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

SPAN_CAPACITY = 1 << 17
MOE_CAPACITY = 1 << 16


class Span(NamedTuple):
    i: int              # the record's index
    name: str
    t0: int             # time.perf_counter_ns()
    t1: int
    parent: int         # index of the enclosing span, -1 for none
    engine: int
    attrs: tuple

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


class Event(NamedTuple):
    i: int
    name: str
    t: int
    engine: int
    rid: int
    note: str


class Tracer:
    """The rings and the stack of open spans.  ``clock`` and ``wall`` are
    the host's two clocks, which a test may replace."""

    def __init__(self, capacity: int = SPAN_CAPACITY,
                 moe_capacity: int = MOE_CAPACITY,
                 clock=time.perf_counter_ns, wall=time.time_ns):
        for c in (capacity, moe_capacity):
            if c < 1 or c & (c - 1):
                raise ValueError(f"ring capacity {c} is not a power of two")
        self.on = True
        self._clock, self._wall = clock, wall
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._mask = capacity - 1
        self.n = 0                       # records made (spans and events)
        self._stack: List[tuple] = []    # open spans: (i, name, engine, t0)
        self._tick_wall = 0
        self._moe_counts: list = [None] * moe_capacity
        self._moe_cap = [0] * moe_capacity
        self._moe_tokens = [0] * moe_capacity
        self._moe_parent = [0] * moe_capacity
        self._moe_mask = moe_capacity - 1
        self.n_moe = 0
        self._held: Optional[list] = None   # MoE entries of a capture
        self._engines = 0
        self._snap: Optional[Snapshot] = None

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def engine_tag(self) -> int:
        """A new engine's tag."""
        self._engines += 1
        return self._engines

    # ---- recording (callers test ``on`` first) --------------------------
    def open(self, name: str, engine: int) -> None:
        """Open ``name`` inside the innermost open span."""
        i = self.n
        self.n = i + 1
        self._ring[i & self._mask] = None     # not closed yet
        self._stack.append((i, name, engine, self._clock()))

    def close(self, attrs: tuple = ()) -> None:
        """Close the innermost open span with ``attrs``."""
        t1 = self._clock()
        i, name, engine, t0 = self._stack.pop()
        st = self._stack
        self._ring[i & self._mask] = (name, t0, t1, st[-1][0] if st else -1,
                                      engine, attrs)

    def lap(self, name: str, attrs: tuple = ()) -> None:
        """Close the innermost open span with ``attrs`` and open its next
        sibling ``name`` at the same instant."""
        t = self._clock()
        i, old, engine, t0 = self._stack.pop()
        st = self._stack
        self._ring[i & self._mask] = (old, t0, t, st[-1][0] if st else -1,
                                      engine, attrs)
        j = self.n
        self.n = j + 1
        self._ring[j & self._mask] = None
        st.append((j, name, engine, t))

    def now(self) -> int:
        """A reading of the clock spans are timed by."""
        return self._clock()

    def record(self, name: str, t0: int, attrs: tuple = ()) -> None:
        """A span ``name`` from ``t0`` (:meth:`now`) to now, made closed
        inside the innermost open span, with its engine tag (0 where none
        is open): a call timed around, whose own records keep the open span
        as their parent."""
        t1 = self._clock()
        i = self.n
        self.n = i + 1
        st = self._stack
        self._ring[i & self._mask] = (name, t0, t1, st[-1][0] if st else -1,
                                      st[-1][2] if st else 0, attrs)

    def open_tick(self, engine: int) -> None:
        """Open ``serve.tick``, a root: spans left open by an exception in
        an earlier tick are dropped."""
        self._stack.clear()
        self.open("serve.tick", engine)
        self._tick_wall = self._wall()

    def close_tick(self, attrs: tuple) -> None:
        self.close((self._tick_wall,) + attrs)

    def event(self, name: str, engine: int, rid: int, note: str = "") -> None:
        i = self.n
        self.n = i + 1
        self._ring[i & self._mask] = (name, self._clock(), engine, rid, note)

    def events(self, name: str, engine: int, rids: Iterable[int]) -> None:
        """One event ``name`` for each of ``rids``, at one instant."""
        t = self._clock()
        for rid in rids:
            i = self.n
            self.n = i + 1
            self._ring[i & self._mask] = (name, t, engine, rid, "")

    def moe(self, counts, cap: int, tokens: int) -> None:
        """Keep a reference to one MoE call's per-expert pair counts."""
        if self._held is not None:
            self._held.append((counts, cap, tokens))
            return
        j = self.n_moe
        self.n_moe = j + 1
        j &= self._moe_mask
        self._moe_counts[j] = counts
        self._moe_cap[j] = cap
        self._moe_tokens[j] = tokens
        st = self._stack
        self._moe_parent[j] = st[-1][0] if st else -1

    @contextlib.contextmanager
    def holding_moe(self):
        """Within the block, on or off, every MoE call hands its entry
        ``(counts, cap, tokens)`` to the list this yields and not to the
        ring: a CUDA graph's capture, whose counts tensors each replay
        overwrites, so that its runner stashes a copy a replay."""
        held, on = [], self.on
        self._held, self.on = held, True
        try:
            yield held
        finally:
            self._held, self.on = None, on

    # ---- reading ----------------------------------------------------------
    def snapshot(self) -> "Snapshot":
        """What the rings hold now, oldest first (the same object until
        something more is recorded)."""
        s = self._snap
        if s is not None and s.n == self.n and s.n_moe == self.n_moe:
            return s
        spans, events = [], []
        for i in range(max(0, self.n - len(self._ring)), self.n):
            r = self._ring[i & self._mask]
            if r is None:
                continue
            (spans if len(r) == 6 else events).append(
                (Span if len(r) == 6 else Event)(i, *r))
        moe = []
        for j in range(max(0, self.n_moe - len(self._moe_counts)),
                       self.n_moe):
            j &= self._moe_mask
            moe.append((self._moe_counts[j], self._moe_cap[j],
                        self._moe_tokens[j], self._moe_parent[j]))
        self._snap = Snapshot(self.n, self.n_moe, spans, events, moe)
        return self._snap


class Snapshot:
    """A reader's view of the rings: spans and events by name, each span's
    children, and the map of a span onto the epoch's clock."""

    def __init__(self, n: int, n_moe: int, spans: List[Span],
                 events: List[Event], moe: List[tuple]):
        self.n, self.n_moe = n, n_moe
        self.spans, self.events, self.moe = spans, events, moe
        self.by_i: Dict[int, Span] = {s.i: s for s in spans}
        self._named: Dict[str, list] = defaultdict(list)
        self._kids: Dict[int, List[Span]] = defaultdict(list)
        for s in spans:
            self._named[s.name].append(s)
            self._kids[s.parent].append(s)
        for e in events:
            self._named[e.name].append(e)

    def named(self, name: str) -> list:
        """Spans (or events) called ``name``, oldest first."""
        return self._named.get(name, [])

    def between(self, name: str, a: int, b: int) -> list:
        """Spans of ``name`` with ``a <= t0`` and ``t1 <= b``, or events
        of ``name`` with ``a <= t <= b``."""
        out = []
        for s in self.named(name):
            lo, hi = (s.t0, s.t1) if isinstance(s, Span) else (s.t, s.t)
            if a <= lo and hi <= b:
                out.append(s)
        return out

    def children(self, span: Span) -> List[Span]:
        return self._kids.get(span.i, [])

    def root(self, span: Span) -> Optional[Span]:
        """The ``serve.tick`` that ``span`` lies in (itself for a tick);
        None where that tick is gone from the ring or there is none."""
        s = span
        while s.parent >= 0:
            s = self.by_i.get(s.parent)
            if s is None:
                return None
        return s if s.name == "serve.tick" else None

    def epoch_offset(self, span: Span) -> Optional[int]:
        """Add to a ``perf_counter_ns`` time of ``span`` to get the epoch's
        ns, from the wall-clock pair of the ``serve.tick`` it lies in;
        None where there is no such tick."""
        tick = self.root(span)
        return None if tick is None else tick.attrs[0] - tick.t0

    def inside(self, names: Sequence[str], times: Sequence[int],
               shift: Dict[int, int]) -> List[bool]:
        """For each epoch-clock instant of ``times``, whether some span of
        ``names`` covers it, each span placed by its ``serve.tick``'s pair
        of clocks and moved ``shift[i]`` ns more, ``i`` that tick's index
        (spans of ticks ``shift`` lacks are left out).  The spans of
        ``names`` must not overlap (calls made one after another on the
        engine's thread)."""
        iv = []
        for name in names:
            for s in self.named(name):
                tick = self.root(s)
                if tick is not None and tick.i in shift:
                    off = tick.attrs[0] - tick.t0 + shift[tick.i]
                    iv.append((s.t0 + off, s.t1 + off))
        iv.sort()
        starts = [a for a, _ in iv]
        out = []
        for t in times:
            k = bisect.bisect_right(starts, t) - 1
            out.append(k >= 0 and iv[k][1] >= t)
        return out


def moe_counts(entries: Sequence[tuple]):
    """(counts (N, E), caps (N,), tokens (N,)) of MoE entries as numpy
    arrays: the counts copied to the host in one copy."""
    counts = torch.stack([e[0] for e in entries]).cpu().numpy()
    return (counts, np.array([e[1] for e in entries], np.int64),
            np.array([e[2] for e in entries], np.int64))


TRACER = Tracer()
