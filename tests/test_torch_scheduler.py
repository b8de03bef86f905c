"""The port's copy of ``core/scheduler.py`` on ``torch.device`` tokens:
the cases of tests/test_scheduler.py and the scheduler drills of
tests/test_faults.py (retries, device-lost quarantine with last-live
protection, speculation, largest-first order), run against the port."""
import threading
import time

import torch

from repro_torch.core.faults import (
    FaultPlan,
    FaultSpec,
    crash_every,
    device_loss_every,
)
from repro_torch.core.scheduler import DynamicScheduler

CPU0, CPU1 = torch.device("cpu", 0), torch.device("cpu", 1)


def test_all_jobs_complete():
    sched = DynamicScheduler(n_workers=4, speculate=False)
    results = sched.run([lambda i=i: i * i for i in range(20)])
    assert [r.value for r in results] == [i * i for i in range(20)]
    assert all(r.ok for r in results)


def test_retry_on_transient_failure():
    attempts = {}
    lock = threading.Lock()

    def flaky(i):
        with lock:
            attempts[i] = attempts.get(i, 0) + 1
            if attempts[i] == 1 and i % 3 == 0:
                raise RuntimeError("transient node failure")
        return i

    sched = DynamicScheduler(n_workers=3, max_retries=2, speculate=False)
    results = sched.run([lambda i=i: flaky(i) for i in range(9)])
    assert all(r.ok for r in results)
    assert [r.value for r in results] == list(range(9))
    assert any(r.attempts > 1 for r in results)


def test_permanent_failure_reported_not_raised():
    def bad():
        raise ValueError("broken candidate")

    sched = DynamicScheduler(n_workers=2, max_retries=1, speculate=False)
    results = sched.run([bad, lambda: 42])
    assert not results[0].ok and "broken candidate" in results[0].error
    assert results[1].ok and results[1].value == 42


def test_injected_crashes_retry_to_completion():
    """Every 3rd job's first attempt crashes; retries with backoff finish
    the batch with the fault-free values."""
    plan = FaultPlan([crash_every(3)])
    sched = DynamicScheduler(n_workers=3, max_retries=2, speculate=False,
                             backoff_base_s=0.001, faults=plan,
                             devices=[CPU0])
    run = sched.submit([lambda device, i=i: i * i for i in range(12)])
    res = run.wait(timeout=30)
    assert all(r.ok for r in res)
    assert [r.value for r in res] == [i * i for i in range(12)]
    crashed = {e.ctx["job_id"] for e in plan.fired(kind="crash")}
    assert crashed == {2, 5, 8, 11}
    assert all(r.attempts == (2 if r.job_id in crashed else 1) for r in res)
    assert run.stats["retries"] == 4 and run.stats["backoff_s"] > 0.0


def test_device_loss_quarantines_and_rebalances():
    """One DeviceLost retires its device at once; every job lands on the
    survivor."""
    plan = FaultPlan([FaultSpec(site="scheduler.job", kind="device_loss",
                                when=lambda c: c["device"] == "cpu:0",
                                times=1)])
    sched = DynamicScheduler(n_workers=2, max_retries=2, speculate=False,
                             devices=[CPU0, CPU1], backoff_base_s=0.001,
                             faults=plan)
    run = sched.submit([lambda device, i=i: i for i in range(8)])
    res = run.wait(timeout=30)
    assert all(r.ok for r in res) and len(res) == 8
    assert run.quarantined == [CPU0] and run.stats["quarantined"] == 1
    assert {r.device for r in res} == {CPU1}


def test_last_live_device_is_never_quarantined():
    plan = FaultPlan([FaultSpec(site="scheduler.job", kind="device_loss",
                                when=lambda c: c["attempt"] == 1)])
    sched = DynamicScheduler(n_workers=2, max_retries=2, speculate=False,
                             devices=[CPU0], backoff_base_s=0.001,
                             faults=plan)
    res = sched.run([lambda device, i=i: i for i in range(6)])
    assert all(r.ok for r in res) and len(res) == 6
    assert all(r.attempts == 2 for r in res)


def test_device_loss_every_drill():
    plan = FaultPlan([device_loss_every(5, times=1)])
    sched = DynamicScheduler(n_workers=2, max_retries=2, speculate=False,
                             devices=[CPU0, CPU1], backoff_base_s=0.001,
                             faults=plan)
    run = sched.submit([lambda device, i=i: i for i in range(8)])
    res = run.wait(timeout=30)
    assert all(r.ok for r in res) and len(res) == 8
    assert [e.ctx["job_id"] for e in plan.fired(kind="device_loss")] == [4]
    assert run.stats["quarantined"] == 1


def test_speculation_waits_for_backlog_but_rescues_straggler():
    twin_ran = threading.Event()
    runs = {}
    lock = threading.Lock()

    def straggler():
        with lock:
            runs["straggler"] = runs.get("straggler", 0) + 1
            first = runs["straggler"] == 1
        if first:
            twin_ran.wait(timeout=10.0)
            return "slow"
        twin_ran.set()
        return "fast"

    def sleeper(i):
        def f():
            with lock:
                runs[i] = runs.get(i, 0) + 1
            time.sleep(0.3)
            return i
        return f

    sched = DynamicScheduler(n_workers=2, max_retries=0, timeout_s=0.3,
                             speculate=True)
    results = sched.run([straggler] + [sleeper(i) for i in range(6)])
    assert results[0].ok and results[0].value in ("fast", "slow")
    assert [r.value for r in results[1:]] == list(range(6))
    assert all(runs[i] == 1 for i in range(6))
    assert runs["straggler"] == 2


def test_speculative_twin_lands_on_other_device():
    release = threading.Event()
    runs = []
    lock = threading.Lock()

    def hangs_once(device):
        with lock:
            runs.append(device)
            first = len(runs) == 1
        if first:
            release.wait(timeout=10.0)
            return "slow"
        release.set()
        return "fast"

    sched = DynamicScheduler(n_workers=2, max_retries=0, timeout_s=0.3,
                             speculate=True, devices=[CPU0, CPU1])
    results = sched.run([hangs_once])
    release.set()
    assert results[0].ok
    assert len(runs) == 2 and runs[0] != runs[1]


def test_twin_ban_cannot_deadlock_on_one_device():
    release = threading.Event()
    runs = []
    lock = threading.Lock()

    def hangs_once(device):
        with lock:
            runs.append(device)
            first = len(runs) == 1
        if first:
            release.wait(timeout=10.0)
            return "slow"
        release.set()
        return "fast"

    sched = DynamicScheduler(n_workers=2, max_retries=0, timeout_s=0.3,
                             speculate=True, devices=[CPU0])
    results = sched.run([hangs_once])
    release.set()
    assert results[0].ok and runs == [CPU0, CPU0]


def test_workers_pinned_round_robin_and_jobs_receive_device():
    barrier = threading.Barrier(4)

    def job(device):
        barrier.wait(timeout=5.0)
        return device

    sched = DynamicScheduler(n_workers=4, speculate=False,
                             devices=[CPU0, CPU1])
    results = sched.run([job] * 4)
    assert all(r.ok for r in results)
    assert sorted(str(r.value) for r in results) == \
        ["cpu:0", "cpu:0", "cpu:1", "cpu:1"]
    assert all(r.device == r.value for r in results)


def test_largest_first_dispatch():
    """``sizes`` turns on LPT order: with one worker the jobs run largest
    first, ties in submission order."""
    order = []
    sched = DynamicScheduler(n_workers=1, speculate=False)
    sizes = [1, 4, 2, 4, 3]
    sched.run([lambda i=i: order.append(i) for i in range(5)], sizes=sizes)
    assert order == [1, 3, 4, 2, 0]


def test_submit_overlaps_host_work_then_wait_collects():
    gate = threading.Event()
    sched = DynamicScheduler(n_workers=2, speculate=False)
    run = sched.submit([lambda: (gate.wait(timeout=10.0), 1)[1]
                        for _ in range(2)])
    assert not run.done()
    gate.set()
    results = run.wait(timeout=30)
    assert run.done() and [r.value for r in results] == [1, 1]
    assert [r.job_id for r in results] == [0, 1]


def test_on_result_hook_fires_once_per_job():
    seen = []
    lock = threading.Lock()

    def hook(r):
        with lock:
            seen.append((r.job_id, r.ok))

    def broken():
        raise ValueError("perma-broken")

    sched = DynamicScheduler(n_workers=3, max_retries=1, speculate=False,
                             backoff_base_s=0.001)
    sched.run([lambda i=i: i for i in range(4)] + [broken], on_result=hook)
    assert sorted(seen) == [(0, True), (1, True), (2, True), (3, True),
                            (4, False)]


def test_empty_submission():
    sched = DynamicScheduler(n_workers=2)
    assert sched.run([]) == []
    run = sched.submit([])
    assert run.done() and run.wait() == []
