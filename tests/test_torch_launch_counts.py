"""Kernel launch counters under concurrent host threads.

The search trains candidates on several scheduler threads, each launching
the conv kernel; ``op.launches += 1`` is a read-modify-write that can lose
counts between threads, so every wrapper counts through
``kernels/_launches.py: count_launch``.  On the CPU no kernel launches, so
the plain path's calls are counted through the same helper, as the chip
script's rehearsals count them.
"""
import sys
import threading
import time

import pytest
import torch

from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.conv1d import dwsep_conv1d, dwsep_conv1d_ref
from repro_torch.kernels.flash_attention import flash_attention
from torch_parity import one_thread  # noqa: F401 (a fixture)

THREADS = 4


@pytest.fixture
def short_switches(monkeypatch):
    """Thread switches every microsecond, restored after the test."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def _run(target, n_threads=THREADS):
    threads = [threading.Thread(target=target) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_counts_survive_four_threads(short_switches, monkeypatch):
    """20,000 counts from each of four threads: none is lost, on a plain
    counter and on a counter by path."""
    monkeypatch.setattr(dwsep_conv1d, "launches", 0)
    monkeypatch.setattr(flash_attention, "launches", 0)
    monkeypatch.setattr(flash_attention, "launches_by_path",
                        dict.fromkeys(flash_attention.launches_by_path, 0))
    path = next(iter(flash_attention.launches_by_path))
    n = 20_000

    def work():
        for _ in range(n):
            count_launch(dwsep_conv1d)
            count_launch(flash_attention, path)
    _run(work)
    assert dwsep_conv1d.launches == THREADS * n
    assert flash_attention.launches == THREADS * n
    assert flash_attention.launches_by_path[path] == THREADS * n


def test_plain_conv_from_four_threads(short_switches, monkeypatch):
    """The conv wrapper's CPU path called from four threads at once, each
    call counted as the card's launch would be: every call is counted and
    every result equals the plain version's."""
    monkeypatch.setattr(dwsep_conv1d, "launches", 0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 8, generator=gen)
    dw, pw = torch.randn(3, 8, generator=gen), torch.randn(8, 4,
                                                            generator=gen)
    b = torch.randn(4, generator=gen)
    want = dwsep_conv1d_ref(x, dw, pw, b, stride=1, relu=True)
    bad = []

    def work():
        for _ in range(200):
            got = dwsep_conv1d(x, dw, pw, b, stride=1, relu=True)
            count_launch(dwsep_conv1d)
            if not torch.equal(got, want):
                bad.append(got)
    _run(work)
    assert dwsep_conv1d.launches == THREADS * 200 and not bad


def test_first_loads_from_four_threads_build_once(monkeypatch):
    """Four threads that load a kernel library for the first time at once
    run one build at a time (a build's temporary file is named by process
    only), and every one gets a library."""
    from repro_torch import _build
    active, builds, lock = [0], [], threading.Lock()

    def build(names):
        with lock:
            active[0] += 1
            builds.append(active[0])
        time.sleep(0.05)
        with lock:
            active[0] -= 1
        return {}
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.load.cache_clear()
    got = []
    try:
        _run(lambda: got.append(_build.load("dwsep_conv1d")))
    finally:
        _build.load.cache_clear()
    assert len(got) == THREADS and max(builds) == 1
