"""The closed loop over the serving engine, and the end-to-end arithmetic.

Each of the mix's clients holds one request at a time: when its reply is
complete it sends the next one, at once.  The loop drives the engine
through ``submit`` / ``tick`` / ``take_finished`` and stamps every token
on its own clock when the ``tick()`` that produced it returns: that is
when a client could see it (the engine's own ``t_first`` is the tick's
start, before the prefill that makes the token).

The end-to-end numbers are plain functions of what the loop records
(:class:`Record`), so they are tested on made-up timestamps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from portbench.harness.traffic import Draw


@dataclasses.dataclass
class Sent:
    """One request as a client saw it."""
    rid: int
    prompt_len: int
    max_new: int
    t_submit: float
    t_first: Optional[float] = None   # end of the tick of its first token
    t_last: Optional[float] = None    # end of the tick of its latest token
    delivered: int = 0
    failed: bool = False
    done: bool = False
    req: object = None                # the engine's request object


@dataclasses.dataclass
class Record:
    """What a run recorded: every request sent, every tick's end, and each
    delivery of tokens (tick end, rid, tokens, gap to that request's
    previous token or None for its first)."""
    sent: Dict[int, Sent] = dataclasses.field(default_factory=dict)
    ticks: List[tuple] = dataclasses.field(default_factory=list)
    deliveries: List[tuple] = dataclasses.field(default_factory=list)
    t_open: float = 0.0
    t_close: float = 0.0


class ClosedLoop:
    """``clients`` callers over ``engine``; ``draws`` yields the requests
    in the order they are sent; ``make_request(rid, draw)`` builds the
    engine's request object."""

    def __init__(self, engine, draws: Iterator[Draw], clients: int,
                 make_request: Callable, clock: Callable[[], float] =
                 time.perf_counter):
        self.engine = engine
        self.draws = draws
        self.clients = clients
        self.make_request = make_request
        self.clock = clock
        self.rec = Record()
        self.open = True              # clients send new requests
        self._t0 = clock()

    def send(self, now: float) -> Sent:
        d = next(self.draws)
        req = self.make_request(d.index, d)
        s = Sent(rid=d.index, prompt_len=len(d.prompt), max_new=d.max_new,
                 t_submit=now, req=req)
        self.rec.sent[s.rid] = s
        if not self.engine.submit(req):       # a full admission queue
            s.failed = s.done = True
        return s

    def start(self) -> None:
        """Every client sends its first request."""
        now = self.clock()
        for _ in range(self.clients):
            self.send(now)

    def tick(self) -> Dict[str, float]:
        """One engine tick; stamps the tokens it delivered and lets each
        client whose reply completed send its next request."""
        eng = self.engine
        before = {r.rid: len(r.out) for r in eng.active if r is not None}
        t_start = self.clock()
        info = eng.tick(t_start - self._t0)
        t_end = self.clock()
        finished = eng.take_finished()
        seen = [r for r in eng.active if r is not None] + finished
        for r in seen:
            s = self.rec.sent[r.rid]
            n = len(r.out) - before.get(r.rid, 0)
            if n > 0:
                gap = None if s.t_last is None else t_end - s.t_last
                self.rec.deliveries.append((t_end, r.rid, n, gap))
                if s.t_first is None:
                    s.t_first = t_end
                s.t_last = t_end
                s.delivered += n
        for r in finished:
            s = self.rec.sent[r.rid]
            s.done = True
            s.failed = bool(r.expired or r.oom or r.rejected)
        self.rec.ticks.append((t_start, t_end, int(info["admitted"]),
                               int(info["produced"])))
        if self.open:
            for _ in finished:
                self.send(t_end)
        return info

    def run_window(self, seconds: float,
                   on_tick: Optional[Callable[[float], None]] = None
                   ) -> None:
        """Tick until ``seconds`` have passed since the window opened; the
        window closes at the end of the tick that crosses it.  Then, with
        no new requests sent, tick until every request sent in the window
        has its first token (for its time to first token)."""
        self.rec.t_open = t = self.clock()
        while t - self.rec.t_open < seconds:
            self.tick()
            t = self.clock()
            if on_tick is not None:
                on_tick(t)
        self.rec.t_close = self.rec.ticks[-1][1]
        self.open = False
        while any(s.t_first is None and not s.failed
                  for s in sent_in_window(self.rec)):
            self.tick()


# ---------------------------------------------------------------------------
# End-to-end metrics over the window [t_open, t_close]
# ---------------------------------------------------------------------------


def window_s(rec: Record) -> float:
    return rec.t_close - rec.t_open


def _in_window(rec: Record, t: float) -> bool:
    return rec.t_open < t <= rec.t_close


def output_tokens(rec: Record) -> int:
    """Tokens delivered to clients by the ticks that ended in the window."""
    return sum(n for t, _, n, _ in rec.deliveries if _in_window(rec, t))


def output_tok_s(rec: Record) -> float:
    return output_tokens(rec) / window_s(rec)


def percentile(values: List[float], q: float) -> float:
    if not values:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, np.float64), q))


def sent_in_window(rec: Record) -> List[Sent]:
    return [s for s in rec.sent.values()
            if rec.t_open <= s.t_submit < rec.t_close]


def ttfts_s(rec: Record) -> List[float]:
    """Submit to the end of the tick of the first token, for every request
    sent in the window that did not fail."""
    return [s.t_first - s.t_submit for s in sent_in_window(rec)
            if s.t_first is not None]


def itls_s(rec: Record) -> List[float]:
    """Every gap between a request's consecutive tokens delivered in the
    window.  A tick that delivers n > 1 tokens of one request (its prefill
    token and a decode token) gives one gap to the previous tick and n - 1
    gaps of 0."""
    out: List[float] = []
    for t, _, n, gap in rec.deliveries:
        if not _in_window(rec, t):
            continue
        if gap is not None:
            out.append(gap)
        out.extend([0.0] * (n - 1))
    return out


def prompt_tok_s(rec: Record) -> float:
    """Prompt tokens of the requests whose prefill finished in the window
    (their first token came in it), over the window."""
    n = sum(s.prompt_len for s in rec.sent.values()
            if s.t_first is not None and _in_window(rec, s.t_first))
    return n / window_s(rec)


def attempted_failed(rec: Record) -> tuple:
    """(requests sent in the window, how many of them failed: shed,
    expired or rejected, or never given a first token)."""
    sent = sent_in_window(rec)
    failed = sum(1 for s in sent if s.failed or s.t_first is None)
    return len(sent), failed


END_TO_END = {
    "output_tok_s": output_tok_s,
    "ttft_p95_ms": lambda rec: 1e3 * percentile(ttfts_s(rec), 95),
    "itl_p95_ms": lambda rec: 1e3 * percentile(itls_s(rec), 95),
    "prompt_tok_s": prompt_tok_s,
}
