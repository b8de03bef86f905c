"""How ``correct`` is decided: what the timed path served, against the plain
reference, once the window has closed.

The numbers, each with a limit in ``portbench/limits/<cell>.json`` (a
cell's limits name the ones it is judged by):

* ``gap``: the widest gap by which a served token's logit lies below the
  reference's best logit at that position (greedy serving: the served
  token is the program's argmax, so a sound program serves a token the
  reference ranks at or next to the top), over the served tokens whose
  routing is clear.  A routed model's token is *at a near-tie* where, at
  some layer, the reference's k-th and (k+1)-th router logits at that
  token lie within the cell's ``tie_margin`` of each other: there bf16
  and f32 can choose apart, and the token's logits then move as far as
  a lower precision moves them.  Every token of a dense model is clear;
* ``gap_p90``: the 90th percentile of the gaps over every served token
  compared, near-ties included: it holds where a few tokens in a
  hundred flip, and fails where a tenth or more are served wrong;
* ``kv_err`` (followed cells only): over the keys and values the timed
  path wrote into the block pool, the worst layer's median row error,
  ``||K_prog[r] - K_ref[r]|| / ||K_ref[r]||`` over rows r (and V's);
* ``kv0_err`` (followed cells only): the widest row error of the first
  layer's keys and values over every row the recorded step's requests
  hold, prompt and decode-written rows alike.  The first layer's rows
  depend on their token and position alone, so no routing moves them.

Also printed, and judged by no limit: ``gap_all`` (the widest gap over
every token, near-ties included) and ``tie_share`` (the share of the
tokens compared that were at a near-tie), with each token's gap and
margin in the log: the witness that a routed model's large gaps come
from near-ties.  (A routed cell's limits need not name ``gap``: where
its sound runs read as high as its control even over clear tokens, it
is printed and not judged; PERF.md gives the readings.)

A dense model is checked *teacher-forced*: a sample of the requests the
window finished, drawn from the seed with the one of most served tokens
in it, each prompt with its served tokens run once through the
reference, and the gaps of each request's last ``per_request`` served
tokens read.

A routed MoE model cannot be: which pairs its capacity drops depends on
every token of the call (the other rows of a decode step, the whole
prefill bucket), so a request alone routes otherwise.  It is *followed*
from the program's state.  During the window's second half, the first
decode step over a full batch is recorded with a copy of the keys and
values every row read (its past) and wrote (its own position)
(:class:`Snapshot`).  A seeded sample of the step's requests has each
one's prefill call recomputed whole, as recorded (pad rows and pad tails
included).  Where the step's rows can lose pairs to capacity (B > C),
the step is computed, every row, from the copied past; where they cannot
(B <= C: an expert takes at most one pair a token), every decode step of
the sampled requests is, each from the copied rows before it.  The
stage this skips, the keys and values, is checked by itself: every K/V
row those prefills and steps wrote, against the reference's (``kv_err``),
and the first layer's rows of every position the step's rows hold
(``kv0_err``).

The control (``prec="fp8"``) is the reference in float8 put in the
program's place: at the same positions, the gap of the token it ranks
first, and the error of its keys and values.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness.loop import Record, Sent

NUMBERS = ("gap", "gap_p90", "kv_err", "kv0_err")


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    served token."""
    tokens = tokens.to(ref_logits.device).long()
    return ref_logits.max(-1).values - ref_logits.gather(
        1, tokens[:, None])[:, 0]


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's (position's) error ``||got[r] - want[r]|| / ||want[r]||``."""
    got = got.float().reshape(got.shape[0], -1)
    want = want.float().reshape(want.shape[0], -1).to(got.device)
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)


def row_median(got: torch.Tensor, want: torch.Tensor) -> float:
    """The median of :func:`row_errors`: rounding reaches every row, while a
    token whose routing flipped at a near-tie (a bf16 rounding away from
    f32's choice) moves its own rows alone, and leaves the median where
    rounding puts it."""
    return float(row_errors(got, want).median())


class Readings:
    """What the check read, per precision: "f32" is the program against the
    reference, "fp8" the control against the reference."""

    def __init__(self):
        self.gaps: Dict[str, List[float]] = {}
        self.ties: Dict[str, List[bool]] = {}
        self.kv_err: Dict[str, float] = {}
        self.kv0_err: Dict[str, float] = {}
        self.tokens = 0
        self.detail: Dict[str, list] = {}      # readings by part, for logs

    def add_gap(self, prec: str, g: torch.Tensor,
                ties: Optional[torch.Tensor] = None) -> None:
        """Gaps of served tokens, and which of them were at a near-tie."""
        g = [float(x) for x in g]
        t = [False] * len(g) if ties is None else [bool(x) for x in ties]
        self.gaps.setdefault(prec, []).extend(g)
        self.ties.setdefault(prec, []).extend(t)
        self.note("gaps_" + prec, [round(x, 4) for x in g])
        if any(t):
            self.note("tie_" + prec, [int(x) for x in t])

    def add_kv(self, prec: str, err: float) -> None:
        self.kv_err[prec] = max(self.kv_err.get(prec, 0.0), err)

    def add_kv0(self, prec: str, err: float) -> None:
        self.kv0_err[prec] = max(self.kv0_err.get(prec, 0.0), err)

    def note(self, key: str, value) -> None:
        self.detail.setdefault(key, []).append(value)

    def numbers(self, prec: str) -> Dict[str, float]:
        """The numbers of the module's docstring that this run read."""
        out: Dict[str, float] = {}
        g = self.gaps.get(prec)
        if g:
            ties = self.ties[prec]
            clear = [x for x, t in zip(g, ties) if not t]
            if clear:
                out["gap"] = max(clear)
            out["gap_p90"] = float(np.percentile(np.asarray(g), 90))
            out["gap_all"] = max(g)
            out["tie_share"] = sum(ties) / len(ties)
        if prec in self.kv_err:
            out["kv_err"] = self.kv_err[prec]
        if prec in self.kv0_err:
            out["kv0_err"] = self.kv0_err[prec]
        return out


# ---------------------------------------------------------------------------
# Dense: teacher-forced over a sample of finished requests
# ---------------------------------------------------------------------------


def finished_sample(rec: Record, rng: np.random.Generator, tokens: int,
                    max_requests: int, per_request: int) -> List[Sent]:
    """Requests finished in the window (complete, not failed): the one of
    most served tokens, then others in a seeded order, until ``tokens``
    served tokens (each request counting at most ``per_request``) or
    ``max_requests`` requests."""
    done = [s for s in rec.sent.values()
            if s.done and not s.failed and s.t_last is not None
            and rec.t_open < s.t_last <= rec.t_close]
    if not done:
        return []
    done.sort(key=lambda s: (-len(s.req.out), s.rid))
    rest = [done[i + 1] for i in rng.permutation(len(done) - 1)]
    out: List[Sent] = []
    n = 0
    for s in [done[0]] + rest:
        if n >= tokens or len(out) >= max_requests:
            break
        out.append(s)
        n += min(len(s.req.out), per_request)
    return out


def teacher_forced(ref, params, cfg: Dict, sample: List[Sent],
                   per_request: int, precs=("f32",)) -> Readings:
    """Each sampled request's prompt and served tokens run once; the gaps of
    its last ``per_request`` served tokens (the deepest positions)."""
    r = Readings()
    for s in sample:
        prompt = torch.as_tensor(np.asarray(s.req.prompt, np.int64))
        out = torch.as_tensor(np.asarray(s.req.out, np.int64))
        seq = torch.cat([prompt, out[:-1]])
        m = min(len(out), per_request)
        at = torch.arange(len(seq) - m, len(seq))
        row = ref.Row(tokens=seq, logits_at=at)
        want, _ = ref.run(params, cfg, [row], prec="f32")
        r.add_gap("f32", gaps(want, out[-m:]))
        r.tokens += m
        for prec in precs:
            if prec != "f32":
                ctrl, _ = ref.run(params, cfg, [row], prec=prec)
                r.add_gap(prec, gaps(want, ctrl.argmax(-1)))
        del want
    return r


# ---------------------------------------------------------------------------
# MoE: followed from the program's state
# ---------------------------------------------------------------------------


class Snapshot:
    """One decode step over a full batch, as the timed path ran it: every
    row's token, length, block table and request, a copy of the keys and
    values each row read from the pool (positions 0..len-1, every layer),
    taken before the step, and of the row the step wrote (position len),
    taken after it.  Copies, so that requests which finish later and the
    blocks they free leave them as they were."""

    def __init__(self, cache, tokens: np.ndarray, slots: list,
                 block_size: int, step: int):
        self.tokens = torch.as_tensor(np.array(tokens, np.int64)).view(-1)
        self.slots = list(slots)
        self.step = step
        self.lens = cache["lens"].cpu().long().clone()
        self.tables = cache["tables"].cpu().long().clone()
        lens = self.lens.numpy()
        self.offsets = np.concatenate([[0], np.cumsum(lens)])
        rows = np.repeat(np.arange(len(lens)), lens)
        pos = np.concatenate([np.arange(n) for n in lens])
        dev = cache["k"].device
        blk = torch.as_tensor(self.tables.numpy()[rows, pos // block_size],
                              device=dev)
        off = torch.as_tensor(pos % block_size, device=dev)
        self.past = {n: [cache[n][i][blk, off].clone()
                         for i in range(cache[n].shape[0])]
                     for n in ("k", "v")}
        b = np.arange(len(lens))
        self._write = (torch.as_tensor(self.tables.numpy()[b, lens //
                                                            block_size],
                                       device=dev),
                       torch.as_tensor(lens % block_size, device=dev))
        self.written: Dict[str, list] = {}

    def read_written(self, cache) -> None:
        """After the step: the row it wrote at each row's position."""
        blk, off = self._write
        self.written = {n: [cache[n][i][blk, off].clone()
                            for i in range(cache[n].shape[0])]
                        for n in ("k", "v")}

    def rows(self, name: str, layer: int, b: int, stop: int
             ) -> torch.Tensor:
        """Row ``b``'s keys or values at positions 0..stop-1 (stop at most
        its length + 1: the step's own row last)."""
        n = int(self.lens[b])
        lo = int(self.offsets[b])
        out = self.past[name][layer][lo:lo + min(stop, n)]
        if stop > n:
            out = torch.cat([out, self.written[name][layer][b:b + 1]])
        return out

    def past_fn(self, b: int, stop: int):
        return lambda layer: (self.rows("k", layer, b, stop),
                              self.rows("v", layer, b, stop))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ts in self.past.values() for t in ts)


def _ties(r: Readings, ref, margins: list, at: torch.Tensor, tie: float
          ) -> torch.Tensor:
    """At flat token indices ``at`` of a call: whether the reference's
    routing came within ``tie`` of a tie at some layer (each token's
    smallest margin is kept in the log beside its gap)."""
    m = ref.min_margin(margins)[at.to(margins[0].device)]
    r.note("margin_f32", [round(float(x), 4) for x in m])
    return m < tie


def follow_decode(ref, params, cfg: Dict, snap: Snapshot, tie: float,
                  precs=("f32",)) -> Readings:
    """The recorded decode step, every row, from the copied past."""
    r = Readings()
    lens, slots = snap.lens, snap.slots
    served = []
    for b, req in enumerate(slots):
        served.append(int(req.out[int(lens[b]) - len(req.prompt) + 1]))
    served = torch.as_tensor(served)
    rows = [ref.Row(tokens=snap.tokens[b:b + 1], start=int(lens[b]),
                    past=snap.past_fn(b, int(lens[b])))
            for b in range(len(slots))]
    margins: list = []
    want, kv = ref.run(params, cfg, rows, prec="f32", keep_kv=True,
                       margins=margins)
    ties = _ties(r, ref, margins, torch.arange(len(rows)), tie)
    r.add_gap("f32", gaps(want, served), ties)
    r.tokens += len(slots)
    n_layers = len(params["layers"])
    want_kv = [[[kv[b][i][j] for b in range(len(rows))] for j in range(2)]
               for i in range(n_layers)]
    got = {"f32": [[[snap.written[name][i][b:b + 1]
                     for b in range(len(rows))]
                    for name in ("k", "v")] for i in range(n_layers)]}
    for prec in precs:
        if prec != "f32":
            ctrl, kvc = ref.run(params, cfg, rows, prec=prec, keep_kv=True)
            r.add_gap(prec, gaps(want, ctrl.argmax(-1)), ties)
            got[prec] = [[[kvc[b][i][j] for b in range(len(rows))]
                          for j in range(2)] for i in range(n_layers)]
    _pooled_kv(r, got, want_kv, "decode", precs)
    return r


def sample_in_flight(snap: Snapshot, rng: np.random.Generator,
                     max_requests: int) -> List[int]:
    """Rows of the recorded step to check: a seeded sample of its requests,
    the longest prompt among them included."""
    slots = snap.slots
    order = sorted(range(len(slots)), key=lambda b: -len(slots[b].prompt))
    rest = [order[1:][i] for i in rng.permutation(len(order) - 1)]
    return [order[0]] + rest[:max_requests - 1]


def follow_prefills(ref, params, cfg: Dict, snap: Snapshot,
                    calls: List[tuple], pick: List[int], tie: float,
                    precs=("f32",)) -> Readings:
    """The requests of rows ``pick`` of the recorded step: each one's
    prefill call recomputed whole, its first token's gap, and its
    prompt's keys and values (as the step read them) against the
    reference's."""
    r = Readings()
    slots = snap.slots
    by_prompt = {np.asarray(slots[b].prompt, np.int32).tobytes(): b
                 for b in pick}
    todo = []     # (call tokens, call lens, {row: slot})
    for tokens, lens in calls:
        tk, ln = tokens.cpu().numpy(), lens.cpu().numpy()
        hits = {}
        for row in range(tk.shape[0]):
            key = tk[row, :int(ln[row])].astype(np.int32).tobytes()
            if key in by_prompt:
                hits[row] = by_prompt.pop(key)
        if hits:
            todo.append((tk, ln, hits))
    if by_prompt:
        raise RuntimeError(f"{len(by_prompt)} sampled requests have no "
                           f"recorded prefill call")
    n_layers = len(params["layers"])
    got = {p: [[[], []] for _ in range(n_layers)] for p in precs}
    want_kv = [[[], []] for _ in range(n_layers)]
    for tk, ln, hits in todo:
        rows = [ref.Row(tokens=torch.as_tensor(tk[i]).long(),
                        logits_at=torch.as_tensor([int(ln[i]) - 1]))
                for i in range(tk.shape[0])]
        margins: list = []
        want, kv = ref.run(params, cfg, rows, prec="f32", keep_kv=True,
                           margins=margins)
        width = tk.shape[1]
        order = list(hits)
        tie_of = dict(zip(order, _ties(r, ref, margins, torch.as_tensor(
            [i * width + int(ln[i]) - 1 for i in order]), tie)))
        ctrl = {p: ref.run(params, cfg, rows, prec=p, keep_kv=True)
                for p in precs if p != "f32"}
        for row, b in hits.items():
            first = torch.as_tensor([int(slots[b].out[0])])
            r.add_gap("f32", gaps(want[row:row + 1], first),
                      tie_of[row].view(1))
            r.tokens += 1
            plen = int(ln[row])
            for i in range(n_layers):
                for j, name in enumerate(("k", "v")):
                    got["f32"][i][j].append(snap.rows(name, i, b, plen))
                    want_kv[i][j].append(kv[row][i][j][:plen])
            for p, (cl, kvc) in ctrl.items():
                r.add_gap(p, gaps(want[row:row + 1],
                                  cl[row:row + 1].argmax(-1)),
                          tie_of[row].view(1))
                for i in range(n_layers):
                    for j in range(2):
                        got[p][i][j].append(kvc[row][i][j][:plen])
        del want, kv, ctrl
    _pooled_kv(r, got, want_kv, "prefill", precs)
    return r


def first_layer_rows(ref, params, cfg: Dict, snap: Snapshot,
                     precs=("f32",)) -> Readings:
    """Every position each row of the recorded step holds (its prompt and
    the tokens its decode steps fed back), through the first layer's keys
    and values: the widest row error against the reference's
    (``kv0_err``)."""
    r = Readings()
    for b, req in enumerate(snap.slots):
        n = int(snap.lens[b])
        plen = len(req.prompt)
        toks = torch.as_tensor(np.concatenate(
            [np.asarray(req.prompt, np.int64),
             np.asarray(req.out[:n - plen], np.int64)]))
        want = ref.first_layer_kv(params, cfg, toks, "f32")
        for prec in precs:
            kv = want if prec == "f32" else ref.first_layer_kv(
                params, cfg, toks, prec)
            for j, name in enumerate(("k", "v")):
                got = snap.rows(name, 0, b, n) if prec == "f32" else kv[j]
                r.add_kv0(prec, float(row_errors(got, want[j]).max()))
    for prec in precs:
        r.note(f"kv0_max_{prec}", round(r.kv0_err.get(prec, 0.0), 5))
    return r


def _pooled_kv(r: Readings, got, want_kv, part: str, precs) -> None:
    """Per layer, K and V apart, the median row error over the rows of
    every request compared: one request whose routing flipped at a
    near-tie moves its own rows, not the median."""
    for prec in precs:
        meds = [row_median(torch.cat(got[prec][i][j]),
                           torch.cat(want_kv[i][j]))
                for i in range(len(want_kv)) for j in range(2)]
        for m in meds:
            r.add_kv(prec, m)
        r.note(f"{part}_kv_median_{prec}", [round(m, 5) for m in meds])


def follow_decodes(ref, params, cfg: Dict, snap: Snapshot, pick: List[int],
                   tie: float, precs=("f32",)) -> Readings:
    """Every decode step of the requests of rows ``pick``, each followed
    from the copied rows before it.  Only where a step's rows cannot lose
    a pair to capacity (an expert takes at most one pair a token, and
    B <= C): each row's tokens are then its own, so a request's steps are
    computed alone, without drops.  Its served tokens' gaps, and every
    K/V row the steps wrote (the median row of each layer over all the
    requests' steps)."""
    r = Readings()
    slots, lens = snap.slots, snap.lens
    free = dict(cfg, capacity_factor=float(cfg["n_experts"]))
    n_layers = len(params["layers"])
    got = {p: [[[], []] for _ in range(n_layers)] for p in precs}
    want_kv = [[[], []] for _ in range(n_layers)]
    for b in pick:
        req = slots[b]
        plen = len(req.prompt)
        n = int(lens[b]) - plen + 1          # decode steps it has run
        out = torch.as_tensor(np.asarray(req.out[:n + 1], np.int64))
        row = ref.Row(tokens=out[:n], start=plen, past_only=True,
                      past=snap.past_fn(b, plen + n))
        margins: list = []
        want, kv = ref.run(params, free, [row], prec="f32", keep_kv=True,
                           margins=margins)
        ties = _ties(r, ref, margins, torch.arange(n), tie)
        r.add_gap("f32", gaps(want, out[1:]), ties)
        r.tokens += n
        for i in range(n_layers):
            for j, name in enumerate(("k", "v")):
                got["f32"][i][j].append(
                    snap.rows(name, i, b, plen + n)[plen:])
                want_kv[i][j].append(kv[0][i][j])
        for prec in precs:
            if prec == "f32":
                continue
            ctrl, kvc = ref.run(params, free, [row], prec=prec,
                                keep_kv=True)
            r.add_gap(prec, gaps(want, ctrl.argmax(-1)), ties)
            for i in range(n_layers):
                for j in range(2):
                    got[prec][i][j].append(kvc[0][i][j])
    _pooled_kv(r, got, want_kv, "decode", precs)
    return r


def merge(*parts: Readings) -> Readings:
    out = Readings()
    for p in parts:
        for prec, g in p.gaps.items():
            out.gaps.setdefault(prec, []).extend(g)
            out.ties.setdefault(prec, []).extend(p.ties[prec])
        for prec, e in p.kv_err.items():
            out.add_kv(prec, e)
        for prec, e in p.kv0_err.items():
            out.add_kv0(prec, e)
        out.tokens += p.tokens
        for k, v in p.detail.items():
            out.detail.setdefault(k, []).extend(v)
    return out


def judge(readings: Readings, limits: Dict[str, float],
          prec: str = "f32") -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's limits name, read for ``prec``.  Nothing compared is not
    correct."""
    read = readings.numbers(prec)
    checks = {name: {"value": read[name], "limit": float(limits[name])}
              for name in NUMBERS if name in limits and name in read}
    wanted = [n for n in NUMBERS if n in limits]
    ok = len(checks) == len(wanted) > 0 and readings.tokens > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
