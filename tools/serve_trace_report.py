#!/usr/bin/env python3
"""What the port's tracer (``repro_torch/trace.py``) costs, and what its
spans say about one traced run of a benchmark cell.  Run from the
repository root on the GPU machine:

    python3 tools/serve_trace_report.py [--workload dbrx-132b.chat]
        [--seed N] [--seconds 50] [--calls 100000]

0. The clocks: ``--probe`` times of a matmul's result copied to the host
   under ``torch.profiler``, each copy's end on the profiler's clock
   against ``time.time_ns()`` read when ``.cpu()`` returned.
1. The recording cost on this host: ns per call of each recording
   primitive over ``--calls`` calls (a span opened and closed, a span
   lapped into its sibling, an event, an MoE stash of a card tensor, a
   site with the tracer off), and the recording sequence of one decode
   tick of the paged engine (its spans and one stash a layer).
2. One run of the cell as ``portbench/run.py --trace 1`` makes it
   (``portbench.harness.bench.run_cell``), whose device trace and
   recorded window are kept, and then:

   * the clock check: for each decode step in the traced part, the lag
     from the end of its ``Memcpy DtoH`` (the argmax's copy) to the end
     of its ``serve.step.sync`` span placed by its tick's pair of host
     clocks, both on the profiler's clock;
   * ``serve.step``'s host time split among ``grow``, ``tables``,
     ``emit`` and its own time, and ``enqueue`` and ``sync``;
   * ``serve.prefill.splice``'s share of an admitting tick;
   * the host's time to first token (``request.first_token`` less
     ``request.submit``) at p50 and p95, beside the client's;
   * the experts a decode step's MoE call reaches, and its drops;
   * the bundle's decode calls by how they ran (``model.decode.graph``:
     ``replay``, ``capture`` or ``eager``), in the run and in the window;
   * records made a decode tick, and the outcomes of ``request.done``.

``--dump PATH`` writes the traced part's sync spans and DtoH copies, on
the profiler's clock, as JSON.

Prints one line per reading, the card (nvidia-smi) first, and last one
JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def per_call_ns(fn, calls: int) -> float:
    t0 = time.perf_counter_ns()
    fn(calls)
    return (time.perf_counter_ns() - t0) / calls


def recording_cost(torch, T, calls: int, layers: int) -> dict:
    """ns per call of each primitive on a tracer of its own, and of one
    decode tick's sequence (what ``ServeEngine.tick`` records when it
    admits nothing), with ``layers`` MoE stashes."""
    counts = torch.zeros(16, dtype=torch.int64, device="cuda")

    def fresh():
        return T.Tracer()

    def spans(n, tr=fresh()):
        for _ in range(n):
            tr.open("serve.step", 1)
            tr.close((64,))

    def laps(n, tr=fresh()):
        tr.open("serve.step.grow", 1)
        for _ in range(n):
            tr.lap("serve.step.tables", (False,))
        tr.close()

    def events(n, tr=fresh()):
        for k in range(n):
            tr.event("request.submit", 1, k)

    def stashes(n, tr=fresh()):
        tr.open("serve.step.enqueue", 1)
        for _ in range(n):
            if tr.on:
                tr.moe(counts, 24, 64)
        tr.close()

    def off(n, tr=fresh()):
        tr.disable()
        for _ in range(n):
            if tr.on:
                tr.moe(counts, 24, 64)

    def ticks(n, tr=fresh()):
        for _ in range(n):
            if tr.on:
                tr.open_tick(1)
                tr.open("serve.expire", 1)
            if tr.on:
                tr.close()
            if tr.on:
                tr.open("serve.step", 1)
            if tr.on:
                tr.open("serve.step.grow", 1)
            if tr.on:
                tr.lap("serve.step.tables")
            if tr.on:
                tr.lap("serve.step.enqueue", (False,))
            for _ in range(layers):
                if tr.on:
                    tr.moe(counts, 24, 64)
            if tr.on:
                tr.lap("serve.step.sync")
            if tr.on:
                tr.lap("serve.step.emit")
            if tr.on:
                tr.close()
                tr.close((64,))
            if tr.on:
                tr.close_tick((0, 64, 0, 64))

    out = {"span_ns": per_call_ns(spans, calls),
           "lap_ns": per_call_ns(laps, calls),
           "event_ns": per_call_ns(events, calls),
           "stash_ns": per_call_ns(stashes, calls),
           "off_site_ns": per_call_ns(off, calls),
           "decode_tick_us": per_call_ns(ticks, calls // 10) / 1e3}
    torch.cuda.synchronize()
    return out


def clock_probe(torch, PT, n: int) -> dict:
    """``n`` matmuls each followed by a copy of part of its result to the
    host: the lag (us) from each copy's end on the profiler's clock to
    ``time.time_ns()`` when ``.cpu()`` returned, which the host cannot
    read before the copy has ended."""
    x = torch.randn(2048, 2048, device="cuda")
    prof = PT.Profiler(torch)
    prof.warm()
    prof.start()
    back = []
    for _ in range(n):
        y = x @ x
        y[0, :8].cpu()
        back.append(time.time_ns())
    tr = prof.stop()
    ends = sorted(b for name, a, b in tr.ops if "Memcpy DtoH" in name)
    if len(ends) != n:
        return {"copies": len(ends), "calls": n}
    return {"lag_us": {k: (v / 1e3 if k != "n" else v) for k, v in
                       quantiles([h - e for h, e in zip(back, ends)]).items()}}


def quantiles(xs):
    xs = sorted(xs)
    if not xs:
        return None
    return {"n": len(xs), "min": xs[0], "median": statistics.median(xs),
            "max": xs[-1]}


def traced_syncs(snap, dtrace):
    """The ``serve.step.sync`` spans inside the traced part, as (start,
    end) on the profiler's clock, and the trace's DtoH copies."""
    syncs = []
    for s in snap.named("serve.step.sync"):
        off = snap.epoch_offset(s)
        if off is not None and dtrace.t0 <= s.t0 + off \
                and s.t1 + off <= dtrace.t1:
            syncs.append((s.t0 + off, s.t1 + off))
    copies = sorted((a, b) for name, a, b in dtrace.ops
                    if "Memcpy DtoH" in name)
    return syncs, copies


def clock_check(np, snap, dtrace, S) -> dict:
    """For each sync in the traced part, the lag (us) from the end of its
    argmax's DtoH copy to the end of its sync span placed by its tick's
    pair of host clocks alone: at the trace's start, and over all of it;
    the copy is the one ``idle_share.enqueue``'s reader follows.  A
    negative lag: the copy ended after the host had its bytes.  The drift
    of the device's clock from the host's: the slope of the lags over the
    trace from 0.5 s on."""
    found = S.metric_reader("idle_share.enqueue").anchors(snap, dtrace)
    at = np.array([(e - dtrace.t0) / 1e9 for e, _, _ in found])
    lag = np.array([-c / 1e3 for _, _, c in found])
    late = at >= 0.5
    return {"syncs": len(found),
            "lag_us": quantiles(lag.tolist()),
            "lag_us_first_0.3s": quantiles(lag[at < 0.3].tolist()),
            "drift_us_per_s": float(np.polyfit(at[late], lag[late], 1)[0])
            if late.sum() > 2 else None,
            "copy_ends_over_50us_late": int((lag < -50).sum())}


def host_readings(np, snap, a: int, b: int, rec, L) -> dict:
    """The breakdowns of PERF.md section 5, over the window before
    tracing, ``[a, b]`` in perf_counter ns."""
    ms = 1e-6
    out = {}
    steps = snap.between("serve.step", a, b)
    parts = {}
    for s in steps:
        kids = snap.children(s)
        for c in kids:
            parts.setdefault(c.name, []).append(c.ns)
        parts.setdefault("self", []).append(
            s.ns - sum(c.ns for c in kids))
    out["step_ms"] = {k.replace("serve.step.", ""): sum(v) / len(steps) * ms
                      for k, v in parts.items()}
    out["step_ms"]["n"] = len(steps)
    out["tables_pushed_share"] = float(np.mean(
        [bool(c.attrs and c.attrs[0]) for s in steps
         for c in snap.children(s) if c.name == "serve.step.tables"]))
    ticks = snap.between("serve.tick", a, b)
    admitting = [t for t in ticks if t.attrs[1] > 0]
    decode = [t for t in ticks if t.attrs[1] == 0]

    def below(span):
        for c in snap.children(span):
            yield c
            yield from below(c)

    def under(tick, name):
        return sum(s.ns for s in below(tick) if s.name == name)
    splice = [under(t, "serve.prefill.splice") for t in admitting]
    out["admitting_tick"] = {
        "n": len(admitting),
        "tick_ms": float(np.mean([t.ns for t in admitting])) * ms,
        "splice_ms": float(np.mean(splice)) * ms,
        "splice_share": float(np.mean([s / t.ns for s, t in
                                       zip(splice, admitting)])),
        "prefill_enqueue_ms": float(np.mean(
            [under(t, "serve.prefill.enqueue") for t in admitting])) * ms,
        "prefill_sync_ms": float(np.mean(
            [under(t, "serve.prefill.sync") for t in admitting])) * ms,
        "admit_ms": float(np.mean(
            [under(t, "serve.admit") for t in admitting])) * ms}
    out["decode_tick"] = {
        "n": len(decode),
        "tick_ms": float(np.mean([t.ns for t in decode])) * ms,
        "expire_ms": float(np.mean([under(t, "serve.expire")
                                    for t in decode])) * ms,
        "outside_step_ms": float(np.mean(
            [t.ns - under(t, "serve.step") for t in decode])) * ms}
    # records a decode tick made: its spans and the MoE stashes under its
    # step's enqueue
    stashes = {}
    for m in snap.moe:
        stashes[m[3]] = stashes.get(m[3], 0) + 1
    spans = [[t] + list(below(t)) for t in decode]
    out["records_per_decode_tick"] = {
        "spans": statistics.median(len(x) for x in spans),
        "stashes": statistics.median(
            sum(stashes.get(s.i, 0) for s in x) for x in spans)}
    # the host's time to first token, beside the client's
    submit = {(e.engine, e.rid): e.t for e in snap.named("request.submit")}
    first = [e.t - submit[e.engine, e.rid]
             for e in snap.between("request.first_token", a, b)
             if (e.engine, e.rid) in submit]
    out["host_ttft_ms"] = {"n": len(first),
                           "p50": float(np.percentile(first, 50)) * ms,
                           "p95": float(np.percentile(first, 95)) * ms}
    out["client_ttft_ms"] = {
        "p50": 1e3 * L.percentile(L.ttfts_s(rec), 50),
        "p95": 1e3 * L.percentile(L.ttfts_s(rec), 95)}
    for key, spans in (("decode_graph_calls", snap.named(
            "model.decode.graph")), ("decode_graph_calls_in_window",
                                     snap.between("model.decode.graph", a,
                                                  b))):
        out[key] = {}
        for s in spans:
            out[key][s.attrs[0]] = out[key].get(s.attrs[0], 0) + 1
    notes = {}
    for e in snap.named("request.done"):
        notes[e.note or "completed"] = notes.get(e.note or "completed", 0) + 1
    out["request_done"] = notes
    return out


def moe_readings(np, T, snap, a: int, b: int) -> dict:
    """Experts reached and pairs dropped by the decode steps' and the
    prefills' MoE calls in ``[a, b]``."""
    out = {}
    for name in ("serve.step.enqueue", "serve.prefill.enqueue"):
        idx = {s.i for s in snap.between(name, a, b)}
        entries = [m for m in snap.moe if m[3] in idx]
        if not entries:
            continue
        counts, caps, tokens = T.moe_counts(entries)
        reached = (counts > 0).sum(1)
        dropped = np.clip(counts - caps[:, None], 0, None).sum(1)
        out[name] = {"calls": len(entries),
                     "experts": int(counts.shape[1]),
                     "reached_mean": float(reached.mean()),
                     "reached_min": int(reached.min()),
                     "tokens_median": float(np.median(tokens)),
                     "cap_median": float(np.median(caps)),
                     "drop_share_pct": 100.0 * float(dropped.sum())
                     / float(counts.sum()),
                     "calls_with_drops": int((dropped > 0).sum())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="dbrx-132b.chat")
    ap.add_argument("--seed", type=int, default=3_141_592_653)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--calls", type=int, default=100_000)
    ap.add_argument("--probe", type=int, default=200)
    ap.add_argument("--dump", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import run as R
    R.cache_dirs()
    import numpy as np
    import torch

    from portbench.harness import bench
    from portbench.harness import loop as L
    from portbench.harness import spec as S
    from portbench.harness import trace as PT
    from repro_torch import trace as T

    if not torch.cuda.is_available():
        log("serve_trace_report: needs a CUDA device")
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    report = {"card": PT.power_limit(), "torch": torch.__version__}
    log(f"[card] {report['card']}; torch {torch.__version__}")
    report["probe"] = clock_probe(torch, PT, args.probe)
    log(f"[probe] {json.dumps(report['probe'])}")
    cell = S.resolve_cell(S.load_spec(ROOT), args.workload, ROOT)
    report["cost"] = recording_cost(torch, T, args.calls,
                                    int(cell.config["n_layers"]))
    log(f"[cost] {json.dumps(report['cost'])}")

    kept = {}
    stop = PT.Profiler.stop

    def keep_trace(self):
        kept["trace"] = stop(self)
        return kept["trace"]
    PT.Profiler.stop = keep_trace

    @dataclasses.dataclass
    class KeptContext(bench.Context):
        def __post_init__(self):
            kept["ctx"] = self
    bench.Context = KeptContext
    out = bench.run_cell(cell, args.seed, args.seconds, True,
                         t_start=T_START)
    report["metrics"] = {k: v["value"] for k, v in out["metrics"].items()}
    report["correct"] = out["correct"]
    log(f"[run] correct {out['correct']}; {json.dumps(report['metrics'])}")
    ctx, dtrace = kept["ctx"], kept["trace"]
    snap = T.TRACER.snapshot()
    a, b = int(ctx.rec.t_open * 1e9), ctx.traced_from_ns
    report["clock"] = clock_check(np, snap, dtrace, S)
    if args.dump is not None:
        syncs, copies = traced_syncs(snap, dtrace)
        args.dump.parent.mkdir(parents=True, exist_ok=True)
        args.dump.write_text(json.dumps({
            "trace": [dtrace.t0, dtrace.t1], "syncs": syncs,
            "copies": copies, "ticks": [
                (t.t0, t.t1, t.attrs) for t in snap.named("serve.tick")
                if t.attrs[0] >= dtrace.t0 - 10 ** 9]}))
    log(f"[clock] {json.dumps(report['clock'])}")
    report["host"] = host_readings(np, snap, a, b, ctx.rec, L)
    for k, v in report["host"].items():
        log(f"[host] {k} {json.dumps(v)}")
    report["moe"] = moe_readings(np, T, snap, a, int(ctx.rec.t_close * 1e9))
    for k, v in report["moe"].items():
        log(f"[moe] {k} {json.dumps(v)}")
    rec = report["host"]["records_per_decode_tick"]
    c = report["cost"]
    report["cost"]["per_decode_tick_us_from_counts"] = (
        rec["spans"] * c["span_ns"] + rec["stashes"] * c["stash_ns"]) / 1e3
    log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
