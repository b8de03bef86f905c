"""Spans around the calls into each layer, and the device trace's reduction.

Spans are taken in the benchmark's own files, around the program's
entry points (the engine's ``tick``, ``_admit`` and ``step``; the
bundle's ``prefill_paged`` and ``decode_paged``), on the host's clock,
each with the inputs a reader needs (device tensors kept by reference and
read once the window has closed).  They cost a few Python calls a span.

The device trace is ``torch.profiler`` with CUDA activity only (CUPTI's
kernel, copy and set records; no per-op host records, whose cost would
slow the host it measures), over the last ``bench.TRACE_S`` seconds of the
window, aggregated in memory.  A kernel belongs to the span it ran in by
its device time: every ``_admit`` (each prefill bucket) and every
``step`` ends in a copy of the argmax to the host, so the kernels
launched in one finish inside it, and none of the next starts before it.
Device times are in the profiler's clock (nanoseconds since the epoch),
spans are mapped onto it through ``time.time_ns()``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Span:
    name: str
    t0: int                 # time.perf_counter_ns()
    t1: int
    meta: Any = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class Spans:
    def __init__(self):
        self.by_name: Dict[str, List[Span]] = defaultdict(list)
        # perf_counter_ns -> the epoch's ns (the profiler's clock)
        self.to_epoch = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, t0: int, t1: int, meta: Any = None) -> None:
        self.by_name[name].append(Span(name, t0, t1, meta))

    def wrap(self, name: str, fn, meta=None, post=None):
        """``fn`` with a span around each call, which keeps ``meta(args)``
        (taken before the call) or ``post(out)`` (after it)."""
        def call(*args, **kwargs):
            m = None if meta is None else meta(args)
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter_ns()
            self.add(name, t0, t1, post(out) if post is not None else m)
            return out
        return call


@dataclasses.dataclass
class DeviceTrace:
    """What the profiler saw: ops ``(name, start_ns, end_ns)`` in the
    epoch's clock, within the traced window ``[t0, t1]``."""
    t0: int
    t1: int
    ops: List[Tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, self.t0
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, end), min(b, self.t1)
            if b > a:
                busy += b - a
                end = b
        return busy / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device in the window."""
        out, end = [], self.t0
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if a > end:
                out.append((end, min(a, self.t1)))
            end = max(end, b)
        if end < self.t1:
            out.append((end, self.t1))
        return [(a, b) for a, b in out if b > a]


class Profiler:
    """``torch.profiler`` over part of the window, CUDA activity only."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = 0

    def warm(self) -> None:
        """One empty session in set-up: the profiler's first start loads
        and initialises CUPTI, seconds that would otherwise fall into the
        traced window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self.torch.ones(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self) -> DeviceTrace:
        self.torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == self.torch.autograd.DeviceType.CUDA:
                ops.append((e.name(), e.start_ns(), e.end_ns()))
        self.prof = None
        return DeviceTrace(self.t0, self.t1, ops)


def in_spans(ops: List[Tuple[str, int, int]], spans: List[Span],
             to_epoch: int) -> List[List[Tuple[str, int, int]]]:
    """For each span, the ops that started on the device inside it."""
    ops = sorted(ops, key=lambda o: o[1])
    out: List[List[Tuple[str, int, int]]] = []
    i = 0
    for s in sorted(spans, key=lambda s: s.t0):
        a, b = s.t0 + to_epoch, s.t1 + to_epoch
        while i < len(ops) and ops[i][1] < a:
            i += 1
        j = i
        while j < len(ops) and ops[j][1] <= b:
            j += 1
        out.append(ops[i:j])
        i = j
    return out


def top_ops(trace: DeviceTrace, n: int = 10) -> List[list]:
    """The device operations that took most time: [[name, seconds]]."""
    tot: Dict[str, int] = defaultdict(int)
    for name, a, b in trace.ops:
        tot[name] += b - a
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in best]


def idle_by_span(trace: DeviceTrace, spans: Spans,
                 names=("model.prefill", "model.decode", "engine.admit",
                        "engine.step", "engine.tick"),
                 n: int = 10) -> List[list]:
    """The device's idle time in the window by what the host was doing:
    each gap goes to the innermost of ``names`` (listed innermost first)
    that covers its start on the host, else to "outside engine.tick"."""
    index = []
    for k in names:
        ss = sorted(spans.by_name.get(k, []), key=lambda s: s.t0)
        index.append((k, [s.t0 + spans.to_epoch for s in ss],
                      [s.t1 + spans.to_epoch for s in ss]))
    tot: Dict[str, int] = defaultdict(int)

    def owner(t: int) -> str:
        for k, starts, ends in index:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                return k
        return "outside engine.tick"
    for a, b in trace.gaps():
        tot[owner(a)] += b - a
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, ns / 1e9] for k, ns in best]


def power_limit() -> Optional[str]:
    """The card's name and power limit from ``nvidia-smi``, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None
