"""Dynamic workload scheduler (paper §III-A).

"We handle the large training workload by implementing a dynamic workload
scheduler, which leverages parallel processing on HPC systems."

A copy of ``repro/core/scheduler.py`` (threads), on the port's
``core/faults.py``.  The device tokens are ``torch.device`` objects
(``repro_torch/launch/mesh.py: local_search_devices``); a worker pinned to
a CUDA device makes it the current device of its thread before it runs a
job, so the job's kernels go to that device's current stream.

On a real cluster a *worker* is a host owning a device group; here a worker
is a thread (PyTorch releases the GIL inside its kernels and while it waits
on the device).  The
scheduler adds the failure semantics required at 1000-node scale
(DESIGN.md §5, §13):

* **re-dispatch on failure** — a job whose worker raised (or timed out) is
  retried up to ``max_retries`` times, with exponential backoff plus
  seeded jitter between attempts (an immediately-retried transient fault
  usually recurs; synchronized retries stampede);
* **straggler mitigation** — the slowest still-running jobs are
  speculatively duplicated (first result wins);
* **heartbeat** — jobs report liveness via a timestamp the scheduler
  inspects; silent workers past ``timeout_s`` are declared dead;
* **device quarantine** — ``quarantine_after`` consecutive failures on one
  device (or a single :class:`~repro_torch.core.faults.DeviceLost`) retire that
  device: its workers exit and its queued jobs rebalance onto the
  surviving devices.  The last live device is never quarantined — partial
  progress beats none.

A *job* is any independent unit of work — the NAS dispatches whole
signature buckets (one bucket = one stacked, vmapped training, DESIGN.md
§9),
so retry and speculation operate on buckets, exactly as they previously
operated on single candidates.

Two orchestration axes added for the overlapped search pipeline
(DESIGN.md §11):

* **Device affinity** — construct with ``devices=[...]`` (one opaque token
  per accelerator, e.g. ``local_search_devices()``) and each worker thread is
  pinned to ``devices[widx % len(devices)]``; jobs are then invoked as
  ``job(device)`` so the payload can place its data on its worker's
  accelerator.  A speculative twin is *banned* from the straggling
  attempt's device (a straggler is as likely a sick device as a sick
  input), falling back to any worker when no other device has a live
  worker.  Retries carry no ban — any device may pick them up.
* **Asynchronous submission** — :meth:`DynamicScheduler.submit` starts the
  batch in background threads and returns a :class:`SchedulerRun` handle;
  the caller overlaps host-side work with the running jobs and collects
  with :meth:`SchedulerRun.wait`.  :meth:`DynamicScheduler.run` is the
  blocking composition ``submit(...).wait()``.

Load balance: ``submit(jobs, sizes=...)`` dispatches largest-first (LPT) —
with device-affine workers pulling from one queue, the big signature
buckets land first and the small ones fill the tail, so per-device busy
time stays level instead of one device finishing a giant bucket after the
rest went idle (the ``device_busy_s`` rebalancing signal, DESIGN.md §11).

Fault injection (DESIGN.md §13): pass ``faults=`` a
:class:`~repro_torch.core.faults.FaultPlan` and every attempt consults the
``"scheduler.job"`` inject point before running its payload — crashes,
hangs and device loss are exercised through this explicit hook, never by
monkeypatching.

Everything is event-driven: workers block on a condition variable (no
dequeue polling; backoff-delayed retries bound the wait timeout), and the
straggler watcher sleeps until the earliest moment a running job can
exceed ``timeout_s`` — or until any state change wakes it.  Speculation
stays gated on "no unfinished job is waiting for a worker", with the
backlog test and the per-job queued/inflight/started-at state read under
the same lock the workers write them under.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.faults import DeviceLost, FaultPlan


@dataclasses.dataclass
class JobResult:
    job_id: int
    ok: bool
    value: Any = None
    error: str = ""
    attempts: int = 1
    elapsed_s: float = 0.0
    worker: int = -1
    device: Any = None   # the winning attempt's device affinity (None =
    #                      scheduler constructed without device affinity)


# one pending dispatch: (job_id, banned_device, earliest_dispatch_time).
# ban != None only on speculative twins; ready_at > now only on backoff-
# delayed retries.
_PendingEntry = Tuple[int, Any, float]


class SchedulerRun:
    """One submitted batch of jobs executing in background threads.

    Returned by :meth:`DynamicScheduler.submit`; the submitting thread is
    free to do host-side work (the search pipeline's overlap window) until
    it calls :meth:`wait`.  All shared state lives behind one condition
    variable; worker threads and the straggler watcher exit on their own
    once every job has a result (or every worker died), so an abandoned
    handle does not leak threads.
    """

    def __init__(self, jobs: Sequence[Callable[..., Any]], *,
                 n_workers: int, max_retries: int, timeout_s: float,
                 speculate: bool,
                 devices: Optional[Sequence[Any]],
                 on_result: Optional[Callable[[JobResult], None]],
                 sizes: Optional[Sequence[float]] = None,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 quarantine_after: int = 3,
                 faults: Optional[FaultPlan] = None,
                 seed: int = 0):
        self._jobs = list(jobs)
        self._n = len(self._jobs)
        self._max_retries = max_retries
        self._timeout_s = timeout_s
        self._speculate = speculate
        self._on_result = on_result
        self._devices = list(devices) if devices else None
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._quarantine_after = max(1, quarantine_after)
        self._faults = faults
        self._rng = random.Random(seed)  # backoff jitter only (wall time,
        #                                  never results)

        self._cond = threading.Condition()
        self._results: Dict[int, JobResult] = {}
        self._attempts: Dict[int, int] = {i: 0 for i in range(self._n)}
        self._started_at: Dict[int, float] = {}
        self._inflight: Dict[int, int] = {}      # job_id -> live attempts
        self._running_dev: Dict[int, Any] = {}   # job_id -> device of the
        #                                          single live attempt
        # largest-first (LPT) initial dispatch when sizes are known; a
        # stable sort keeps submission order inside one size class
        order = range(self._n) if sizes is None else \
            sorted(range(self._n), key=lambda i: -float(sizes[i]))
        self._pending: Deque[_PendingEntry] = deque(
            (i, None, 0.0) for i in order)
        self._alive = 0
        self._alive_devices: Dict[int, Any] = {}  # widx -> device
        self._fail_streak: Dict[str, int] = {}    # device key -> streak
        self._quarantined: set = set()            # device keys
        self.quarantined: List[Any] = []          # device tokens (stats)
        self.stats: Dict[str, float] = {"retries": 0, "backoff_s": 0.0,
                                        "quarantined": 0}

        if self._n == 0:
            return
        self._alive = n_workers
        # Register every worker's device BEFORE starting any thread: an
        # eagerly-scheduled first worker can fail (even DeviceLost) while
        # later workers are still being spawned, and the quarantine logic
        # must see the full device set or it mistakes the failing device
        # for the last live one and refuses to retire it.
        for w in range(n_workers):
            self._alive_devices[w] = self._devices[w % len(self._devices)] \
                if self._devices else None
        for w in range(n_workers):
            threading.Thread(target=self._worker,
                             args=(w, self._alive_devices[w]),
                             daemon=True, name=f"sched-worker-{w}").start()
        if speculate:
            threading.Thread(target=self._watcher, daemon=True,
                             name="sched-watcher").start()

    # ----------------------------------------------------------- public API
    def done(self) -> bool:
        with self._cond:
            return len(self._results) >= self._n or self._alive == 0

    def wait(self, timeout: Optional[float] = None) -> List[JobResult]:
        """Block until every job has a result (or every worker died, in
        which case the partial results are returned — the caller aligns by
        ``job_id``).  Results come back sorted by job id."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._results) < self._n and self._alive > 0:
                rest = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if rest == 0.0:
                    break
                self._cond.wait(timeout=rest)
            return [self._results[i] for i in sorted(self._results)]

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _dev_key(device: Any) -> str:
        return str(device)

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with jitter before retry ``attempt + 1``:
        ``base * 2**(attempt-1)`` capped, times a uniform [1, 2) jitter."""
        if self._backoff_base_s <= 0.0:
            return 0.0
        raw = min(self._backoff_base_s * (2.0 ** (attempt - 1)),
                  self._backoff_cap_s)
        return raw * (1.0 + self._rng.random())

    def _note_failure(self, device: Any, device_lost: bool) -> None:
        """Track consecutive failures per device; quarantine a device that
        keeps failing (or reported lost) so its queued work rebalances onto
        the survivors.  Caller holds the lock."""
        if device is None:
            return
        k = self._dev_key(device)
        if device_lost:
            self._fail_streak[k] = self._quarantine_after
        else:
            self._fail_streak[k] = self._fail_streak.get(k, 0) + 1
        if self._fail_streak[k] < self._quarantine_after \
                or k in self._quarantined:
            return
        live = {self._dev_key(d) for d in self._alive_devices.values()
                if d is not None} - self._quarantined
        if live <= {k}:
            return  # never quarantine the last live device
        self._quarantined.add(k)
        self.quarantined.append(device)
        self.stats["quarantined"] += 1
        self._cond.notify_all()  # pinned workers wake up and exit

    # -------------------------------------------------------------- workers
    def _eligible(self, ban: Any, device: Any) -> bool:
        """May a worker pinned to ``device`` take this pending entry?  A
        twin's device ban applies only while some *other* live worker could
        honor it — affinity must never deadlock the queue."""
        if ban is None or device is None or ban != device:
            return True
        return not any(d != ban for d in self._alive_devices.values())

    def _take(self, device: Any, now: float
              ) -> Tuple[Optional[int], Optional[float]]:
        """Pop the first eligible, *ready* pending job id (stale twins of
        finished jobs are dropped on the way).  Returns ``(job_id, None)``
        or ``(None, wait_s)`` where ``wait_s`` bounds the sleep until the
        earliest backoff-delayed entry becomes ready (``None`` = nothing
        schedulable, wait for a state change).  Caller holds the lock."""
        soonest: Optional[float] = None
        for _ in range(len(self._pending)):
            entry = self._pending.popleft()
            jid, ban, ready_at = entry
            if jid in self._results and self._results[jid].ok:
                continue  # stale twin of a finished job
            if ready_at > now:
                rest = ready_at - now
                soonest = rest if soonest is None else min(soonest, rest)
                self._pending.append(entry)  # backoff not elapsed
                continue
            if self._eligible(ban, device):
                return jid, None
            self._pending.append(entry)  # rotate: not for this worker
        return None, soonest

    def _worker(self, widx: int, device: Any) -> None:
        try:
            if isinstance(device, torch.device) and device.type == "cuda":
                torch.cuda.set_device(device)  # current device: per thread
            self._worker_loop(widx, device)
        finally:
            with self._cond:
                self._alive -= 1
                self._alive_devices.pop(widx, None)
                self._cond.notify_all()

    def _worker_loop(self, widx: int, device: Any) -> None:
        while True:
            with self._cond:
                while True:
                    if len(self._results) >= self._n:
                        return
                    if device is not None \
                            and self._dev_key(device) in self._quarantined:
                        return  # retired with its device
                    jid, wait_s = self._take(device, time.monotonic())
                    if jid is not None:
                        break
                    self._cond.wait(timeout=wait_s)
                self._attempts[jid] += 1
                att = self._attempts[jid]
                self._inflight[jid] = self._inflight.get(jid, 0) + 1
                if self._inflight[jid] == 1:
                    self._running_dev[jid] = device
                self._started_at[jid] = time.monotonic()
                self._cond.notify_all()  # job left the queue: watcher re-arms
            t0 = time.monotonic()
            device_lost = False
            try:
                if self._faults is not None:
                    self._faults.fire("scheduler.job", job_id=jid,
                                      attempt=att, worker=widx,
                                      device=None if device is None
                                      else self._dev_key(device))
                value = self._jobs[jid](device) if self._devices is not None \
                    else self._jobs[jid]()
                res = JobResult(jid, True, value=value, attempts=att,
                                elapsed_s=time.monotonic() - t0,
                                worker=widx, device=device)
            except Exception as e:  # noqa: BLE001 — worker failure is data
                device_lost = isinstance(e, DeviceLost)
                res = JobResult(jid, False, error=traceback.format_exc(),
                                attempts=att,
                                elapsed_s=time.monotonic() - t0,
                                worker=widx, device=device)
            with self._cond:
                self._inflight[jid] -= 1
                if jid in self._results and self._results[jid].ok:
                    self._cond.notify_all()
                    continue  # lost the speculation race
                if res.ok:
                    if device is not None:
                        self._fail_streak[self._dev_key(device)] = 0
                    self._results[jid] = res
                    if self._on_result:
                        self._on_result(res)
                else:
                    self._note_failure(device, device_lost)
                    if att <= self._max_retries:
                        delay = self._backoff(att)
                        self.stats["retries"] += 1
                        self.stats["backoff_s"] += delay
                        self._pending.append(
                            (jid, None, time.monotonic() + delay))
                    else:
                        self._results[jid] = res
                        if self._on_result:
                            self._on_result(res)
                self._cond.notify_all()

    # -------------------------------------------------------------- watcher
    def _watcher(self) -> None:
        """Straggler watch: once no unfinished job is waiting for a worker,
        a job past ``timeout_s`` with a single live attempt gets duplicated
        — first result wins.  The twin is banned from the straggling
        attempt's device so it lands on a different accelerator when one
        has a live worker."""
        with self._cond:
            while len(self._results) < self._n and self._alive > 0:
                wait_s: Optional[float] = None
                backlog = any(jid not in self._results
                              for jid, _, _ in self._pending)
                if not backlog:
                    now = time.monotonic()
                    for jid in range(self._n):
                        if jid in self._results \
                                or any(p == jid
                                       for p, _, _ in self._pending):
                            continue
                        if self._inflight.get(jid, 0) != 1:
                            continue
                        run_s = now - self._started_at.get(jid, now)
                        if run_s > self._timeout_s:
                            self._attempts[jid] = 0  # fresh twin budget
                            self._pending.append(
                                (jid, self._running_dev.get(jid), 0.0))
                            self._cond.notify_all()
                        else:
                            rest = self._timeout_s - run_s
                            wait_s = rest if wait_s is None \
                                else min(wait_s, rest)
                self._cond.wait(timeout=wait_s)
            self._cond.notify_all()


class DynamicScheduler:
    """Run batches of independent jobs with retries + speculative execution.

    ``devices`` (optional) turns on device-affine dispatch: one opaque
    token per accelerator; worker ``w`` is pinned to
    ``devices[w % len(devices)]`` and jobs are invoked as ``job(device)``
    instead of ``job()`` so the payload can stage its data there.

    Failure knobs (DESIGN.md §13): retries back off exponentially from
    ``backoff_base_s`` (doubling per attempt, capped at ``backoff_cap_s``,
    jittered); ``quarantine_after`` consecutive failures on one device —
    or one :class:`~repro_torch.core.faults.DeviceLost` — retire it for the rest
    of the batch (never the last live device).  ``faults`` wires a
    :class:`~repro_torch.core.faults.FaultPlan` into every attempt's
    ``"scheduler.job"`` inject point.
    """

    def __init__(self, n_workers: int = 4, max_retries: int = 2,
                 timeout_s: float = 3600.0, speculate: bool = True,
                 devices: Optional[Sequence[Any]] = None,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 quarantine_after: int = 3,
                 faults: Optional[FaultPlan] = None,
                 seed: int = 0):
        self.n_workers = max(1, n_workers)
        self.max_retries = max_retries
        self.timeout_s = timeout_s
        self.speculate = speculate
        self.devices = list(devices) if devices else None
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.quarantine_after = quarantine_after
        self.faults = faults
        self.seed = seed

    def submit(self, jobs: Sequence[Callable[..., Any]],
               on_result: Optional[Callable[[JobResult], None]] = None,
               sizes: Optional[Sequence[float]] = None) -> SchedulerRun:
        """Start ``jobs`` in the background; returns the run handle.  The
        caller may overlap host-side work until :meth:`SchedulerRun.wait`.
        ``on_result`` fires under the scheduler lock as each job finishes
        (first ok attempt, or the final failed retry) — keep it short and
        never let it raise (a raising callback kills its worker).
        ``sizes`` (one weight per job) turns on largest-first dispatch."""
        return SchedulerRun(
            jobs, n_workers=self.n_workers, max_retries=self.max_retries,
            timeout_s=self.timeout_s, speculate=self.speculate,
            devices=self.devices, on_result=on_result, sizes=sizes,
            backoff_base_s=self.backoff_base_s,
            backoff_cap_s=self.backoff_cap_s,
            quarantine_after=self.quarantine_after,
            faults=self.faults, seed=self.seed)

    def run(self, jobs: Sequence[Callable[..., Any]],
            on_result: Optional[Callable[[JobResult], None]] = None,
            sizes: Optional[Sequence[float]] = None) -> List[JobResult]:
        if len(jobs) == 0:
            return []
        return self.submit(jobs, on_result=on_result, sizes=sizes).wait()
