"""Deterministic fault-injection harness (DESIGN.md §13).

A copy of ``repro/core/faults.py`` (numpy and threading only).  Of its
inject points the port has ``serve.decode`` (the engine), ``serve.replica``
and ``router.dispatch`` (the router) so far.

A :class:`FaultPlan` *schedules* faults; components *expose inject points*
(explicit hooks — never monkeypatching) and consult the plan at each one.
A fault fires when its :class:`FaultSpec` matches the site's hit counter
(``at`` / ``every``) and its context predicate (``when``).  Everything is
deterministic given the plan: counters advance one per hook call, the only
randomness is the plan's own seeded generator (used by helpers like
:func:`FaultPlan.corrupt_file`), so two runs wired to equal plans see the
same faults at the same points.

Inject points in this repo (the component calls the hook; the table is
normative — see DESIGN.md §13):

====================  ======================================================
site                  where / context keys
====================  ======================================================
``scheduler.job``     worker about to execute a job attempt
                      (``job_id``, ``attempt``, ``worker``, ``device``)
``trainer.result``    one trained candidate's result is being recorded
                      (``phash``, ``generation``)
``search.generation`` top of a resumable search's generation loop
                      (``generation``)
``ckpt.save``         a checkpoint was just written (``path``)
``serve.decode``      serve engine about to run a decode step (``step``)
``serve.replica``     router health-checks a live serving replica at the
                      top of a tick (``replica``, ``tick``, ``step``)
``router.dispatch``   router about to hand a request to a replica
                      (``rid``, ``replica``, ``tick``)
====================  ======================================================

Fault kinds and their actions under :meth:`FaultPlan.fire`:

* ``crash``       — raise :class:`InjectedCrash` (a failed worker attempt);
* ``device_loss`` — raise :class:`DeviceLost` (the scheduler quarantines
  the attempt's device immediately);
* ``hang``        — sleep ``hang_s`` then return (a stalled worker: the
  straggler watcher / pytest-timeout see a silent job);
* ``preempt``     — raise :class:`Preemption` (a ``KeyboardInterrupt``
  subclass: SIGTERM/ctrl-C semantics, exercised by ``run_resumable``);
* ``nonfinite`` / ``corrupt`` / any data kind — no action; the spec is
  *returned to the caller*, which applies the corruption itself (a NaN
  training result, a truncated checkpoint file, a serve-decode stall).

:meth:`FaultPlan.check` is the pure variant: it counts the hit and returns
the matching spec without acting — for callers that must stay in control
of time (the serve engine's virtual clock advances instead of sleeping).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """Base class for every exception the harness raises on purpose."""


class InjectedCrash(InjectedFault):
    """A worker attempt dying mid-job (process kill, OOM, assert)."""


class DeviceLost(InjectedCrash):
    """An accelerator disappearing under a job (XID error, preempted VM).

    The scheduler treats this as *device* failure, not job failure: the
    device is quarantined immediately and the job retries elsewhere.
    """


class Preemption(KeyboardInterrupt):
    """Injected SIGTERM/ctrl-C — a ``KeyboardInterrupt`` subclass so the
    graceful-preemption path in ``run_resumable`` handles real and
    injected preemptions identically."""


#: kinds whose action is raising from inside :meth:`FaultPlan.fire`
RAISING_KINDS = ("crash", "device_loss", "preempt")
#: kinds the caller applies itself (fire/check just return the spec)
DATA_KINDS = ("nonfinite", "corrupt", "stall")
KINDS = RAISING_KINDS + DATA_KINDS + ("hang",)


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: *where* (site), *what* (kind), *when* (hit
    pattern + optional context predicate).

    Hit counters are 1-based and per-site: ``at=(3,)`` fires on the site's
    third hook call, ``every=4`` on every fourth.  ``times`` caps the total
    number of fires (``None`` = unlimited).  ``when`` sees the hook call's
    context dict and must also hold for the fault to fire — use it for
    concurrency-safe matching (e.g. ``job_id``-keyed crashes are
    deterministic regardless of worker interleaving; raw counters at a
    multi-threaded site are not).
    """

    site: str
    kind: str
    every: int = 0
    at: Tuple[int, ...] = ()
    times: Optional[int] = None
    hang_s: float = 0.0
    when: Optional[Callable[[Dict[str, Any]], bool]] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(kinds: {KINDS})")
        if not self.every and not self.at and self.when is None:
            raise ValueError(
                "FaultSpec needs a trigger: every=, at=, or when=")

    def matches(self, hit: int, ctx: Dict[str, Any]) -> bool:
        if self.when is not None and not self.when(ctx):
            return False
        if self.at and hit in self.at:
            return True
        if self.every and hit % self.every == 0:
            return True
        # pure-predicate spec: every hit the predicate accepts
        return self.when is not None and not self.at and not self.every


@dataclasses.dataclass
class FaultEvent:
    """One fired fault — the plan's audit log entry."""

    site: str
    hit: int
    kind: str
    ctx: Dict[str, Any]


class FaultPlan:
    """A seeded, deterministic schedule of faults over named inject points.

    Thread-safe: sites are hit from scheduler worker threads.  The plan is
    inert unless a component was handed it explicitly (``faults=`` kwargs
    throughout the repo); a ``None`` plan means production behavior.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.events: List[FaultEvent] = []
        self._hits: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}  # spec index -> fires so far
        self._lock = threading.Lock()

    # ------------------------------------------------------------- matching
    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self, site: Optional[str] = None,
              kind: Optional[str] = None) -> List[FaultEvent]:
        """Audit-log query for test assertions."""
        with self._lock:
            return [e for e in self.events
                    if (site is None or e.site == site)
                    and (kind is None or e.kind == kind)]

    def check(self, site: str, **ctx: Any) -> Optional[FaultSpec]:
        """Count a hit at ``site``; return the scheduled fault (if any)
        WITHOUT acting on it.  First matching spec wins per hit."""
        with self._lock:
            self._hits[site] = hit = self._hits.get(site, 0) + 1
            for si, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.times is not None \
                        and self._fires.get(si, 0) >= spec.times:
                    continue
                if spec.matches(hit, ctx):
                    self._fires[si] = self._fires.get(si, 0) + 1
                    self.events.append(FaultEvent(site, hit, spec.kind,
                                                  dict(ctx)))
                    return spec
        return None

    def fire(self, site: str, **ctx: Any) -> Optional[FaultSpec]:
        """Count a hit and ACT on the scheduled fault: raising kinds raise,
        ``hang`` sleeps, data kinds are returned for the caller to apply
        (``None`` when nothing fires)."""
        spec = self.check(site, **ctx)
        if spec is None:
            return None
        what = f"injected {spec.kind} at {site} (hit {self._hits[site]})"
        if spec.kind == "hang":
            time.sleep(spec.hang_s)
            return spec
        if spec.kind == "device_loss":
            raise DeviceLost(what)
        if spec.kind == "crash":
            raise InjectedCrash(what)
        if spec.kind == "preempt":
            raise Preemption(what)
        return spec

    # ------------------------------------------------------------- actions
    def corrupt_file(self, path: str, mode: str = "truncate") -> None:
        """Deterministically damage a file on disk (the ``corrupt`` kind's
        payload, applied by the caller that owns the path).  ``truncate``
        keeps the first half; ``garbage`` overwrites the tail with bytes
        drawn from the plan's seeded generator."""
        with open(path, "rb") as f:
            data = f.read()
        keep = len(data) // 2
        if mode == "truncate":
            blob = data[:keep]
        elif mode == "garbage":
            tail = self.rng.integers(0, 256, max(len(data) - keep, 1),
                                     dtype=np.uint8).tobytes()
            blob = data[:keep] + tail
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        with open(path, "wb") as f:
            f.write(blob)


def _job_keyed(n: int, kind: str, site: str, first_attempt_only: bool,
               times: Optional[int]) -> FaultSpec:
    """Job-keyed drill spec: fire ``kind`` on every ``n``-th job's first
    attempt.  Keyed on the context's ``job_id``/``attempt`` (not the raw
    hit counter), so the schedule is deterministic under any worker
    interleaving."""
    def when(ctx: Dict[str, Any]) -> bool:
        jid = ctx.get("job_id")
        if jid is None or (jid + 1) % n != 0:
            return False
        return not first_attempt_only or ctx.get("attempt", 1) == 1
    return FaultSpec(site=site, kind=kind, when=when, times=times)


def crash_every(n: int, *, site: str = "scheduler.job",
                first_attempt_only: bool = True,
                times: Optional[int] = None) -> FaultSpec:
    """Convenience: crash every ``n``-th *job* at ``site``: job
    ``n-1, 2n-1, ...`` fails its first attempt and succeeds on retry —
    the canonical crash-and-recover drill."""
    return _job_keyed(n, "crash", site, first_attempt_only, times)


def device_loss_every(n: int, *, site: str = "scheduler.job",
                      first_attempt_only: bool = True,
                      times: Optional[int] = None) -> FaultSpec:
    """Convenience: lose the device under every ``n``-th *job* — the
    quarantine-and-rebalance drill (:class:`DeviceLost` retires the
    device instantly; the job retries on a survivor)."""
    return _job_keyed(n, "device_loss", site, first_attempt_only, times)


def stall_every(n: int, hang_s: float, *, site: str = "serve.decode",
                times: Optional[int] = None) -> FaultSpec:
    """Convenience: stall every ``n``-th hit at ``site`` for ``hang_s``
    (virtual seconds on clock-owning components, real sleep elsewhere) —
    the straggler/heartbeat drill.  Counter-keyed: meant for
    single-threaded sites (``serve.decode``, ``serve.replica``) where hit
    order is deterministic."""
    return FaultSpec(site=site, kind="stall", every=n, hang_s=hang_s,
                     times=times)


def nan_candidate_every(n: int, *, times: Optional[int] = None) -> FaultSpec:
    """Convenience: poison every ``n``-th recorded training result with a
    non-finite loss (the per-candidate quarantine drill)."""
    return FaultSpec(site="trainer.result", kind="nonfinite", every=n,
                     times=times)
