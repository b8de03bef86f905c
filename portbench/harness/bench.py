"""One run of one cell: set-up, the measured window, the metrics, the check.

The system under test is ``repro_torch``'s paged serving engine
(``ServeEngine`` with ``EngineConfig(paged=True, block_size=16)``) over
the LM bundle of the cell's configuration, driven through ``submit`` /
``tick`` / ``take_finished`` by the closed loop of ``loop.py``.  The
benchmark draws the weights (``weights.py``) and the requests
(``traffic.py``) from the seed; the engine gets nothing else.
"""
from __future__ import annotations

import dataclasses
import json
import os
import resource
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from portbench.harness import check as C
from portbench.harness import loop as L
from portbench.harness import spec as S
from portbench.harness import trace as T
from portbench.harness import traffic
from portbench.harness.weights import draw_params, n_params

CHECK_SALT = 0x5EED_C4EC      # the check's sample: its own stream of the seed
TRACE_S = 3.0                 # the traced part of a --trace 1 window
KERNELS = {"dense": ("flash_attention", "decode_attention"),
           "moe": ("flash_attention", "decode_attention", "moe_gmm")}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def model_config(conf: Dict[str, Any]):
    """The port's ModelConfig of a configuration file: its published
    config with every model key the file states (``n_layers`` cut)."""
    from repro_torch.configs import get_config
    base = get_config(conf["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in conf.items()
                                        if k in fields and k != "name"})


class Probe:
    """What the benchmark keeps of the timed path, from wrappers around
    the bundle's paged entry points and the engine's methods: every
    prefill call's input tensors (for the check), one decode step over a
    full batch in the window's second half with the keys and values it
    read and wrote (``check.Snapshot``), and, when tracing, spans."""

    def __init__(self, bundle, spans: Optional[T.Spans], block_size: int):
        self.prefills: List[tuple] = []
        self.snap: Optional[C.Snapshot] = None
        self.snap_after = float("inf")   # perf_counter time to record from
        self.snap_ms = 0.0               # host time the copies took
        self.decode_steps = 0
        self.spans = spans
        self.engine = None
        prefill, decode = bundle.prefill_paged, bundle.decode_paged

        def prefill_paged(params, batch):
            self.prefills.append((batch["tokens"], batch["lens"]))
            return prefill(params, batch)

        def decode_paged(params, cache, batch):
            self.decode_steps += 1
            active = self.engine.active
            if self.snap is not None or time.perf_counter() < \
                    self.snap_after or any(r is None for r in active):
                return decode(params, cache, batch)
            t0 = time.perf_counter()
            snap = C.Snapshot(cache, self.engine.last_tok, active,
                              block_size, self.decode_steps)
            t1 = time.perf_counter()
            out = decode(params, cache, batch)
            t2 = time.perf_counter()
            snap.read_written(cache)
            self.snap = snap
            self.snap_ms = 1e3 * (t1 - t0 + time.perf_counter() - t2)
            return out

        if spans is not None:
            prefill_paged = spans.wrap(
                "model.prefill", prefill_paged,
                lambda a: (tuple(a[1]["tokens"].shape), a[1]["lens"]))
            decode_paged = spans.wrap("model.decode", decode_paged)
        bundle.prefill_paged = prefill_paged
        bundle.decode_paged = decode_paged

    def attach(self, engine) -> None:
        self.engine = engine
        if self.spans is None:
            return
        sp = self.spans
        engine.tick = sp.wrap("engine.tick", engine.tick,
                              post=lambda out: out["admitted"])
        engine._admit = sp.wrap("engine.admit", engine._admit,
                                post=lambda out: out)
        engine.step = sp.wrap("engine.step", engine.step,
                              lambda a: engine.cache["lens"])


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader gets (``portbench/metrics``)."""
    cfg: Dict[str, Any]            # the configuration file's keys
    rec: L.Record
    spans: T.Spans
    trace: Optional[T.DeviceTrace]
    traced_from_ns: int            # perf_counter_ns when tracing began
    block_size: int
    lens: Dict[int, np.ndarray]    # id(tensor) -> host copy

    def host(self, name: str) -> List[T.Span]:
        """Spans of ``name`` inside the window and before tracing began
        (the profiler's own cost is left out of host times)."""
        a = int(self.rec.t_open * 1e9)
        return [s for s in self.spans.by_name.get(name, [])
                if s.t0 >= a and s.t1 <= self.traced_from_ns]

    def traced(self, name: str) -> List[T.Span]:
        """Spans of ``name`` inside the traced part of the window."""
        if self.trace is None:
            return []
        to = self.spans.to_epoch
        return [s for s in self.spans.by_name.get(name, [])
                if s.t0 + to >= self.trace.t0 and s.t1 + to <= self.trace.t1]

    def ops_in(self, spans: List[T.Span]) -> List[list]:
        return T.in_spans(self.trace.ops, spans, self.spans.to_epoch)

    def within(self, inner: str, outer: List[T.Span]) -> List[T.Span]:
        """Spans of ``inner`` that lie inside one of ``outer``."""
        out = []
        for s in self.spans.by_name.get(inner, []):
            if any(o.t0 <= s.t0 and s.t1 <= o.t1 for o in outer):
                out.append(s)
        return out

    def host_lens(self, t) -> np.ndarray:
        return self.lens[id(t)]

    def prompt_lens_before_trace(self) -> List[int]:
        """Prompt lengths of the requests admitted in the window before
        tracing began (their first token came then)."""
        a, b = self.rec.t_open, self.traced_from_ns / 1e9
        return [s.prompt_len for s in self.rec.sent.values()
                if s.t_first is not None and a < s.t_first <= b
                and s.t_first <= self.rec.t_close]


def _host_lens(torch, spans: T.Spans) -> Dict[int, np.ndarray]:
    """Every lens tensor the spans kept, copied to the host at once."""
    ts = [s.meta for s in spans.by_name.get("engine.step", [])]
    ts += [s.meta[1] for s in spans.by_name.get("model.prefill", [])]
    out: Dict[int, np.ndarray] = {}
    if ts:
        flat = torch.cat([t.reshape(-1) for t in ts]).cpu().numpy()
        lo = 0
        for t in ts:
            out[id(t)] = flat[lo:lo + t.numel()]
            lo += t.numel()
    return out


def warm_up(torch, bundle, params, mix: Dict[str, Any], device) -> None:
    """The prefill shapes at the mix's shortest and longest prompts, alone
    and at the widest bucket, so that the allocator and the libraries have
    met them before the window."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    widest = int(mix.get("max_prefill_batch", 8))
    for b, s in ((1, lo), (1, hi), (widest, lo)):
        pad = -(-s // 8) * 8
        tokens = torch.zeros((b, pad), dtype=torch.int32, device=device)
        lens = torch.full((b,), s, dtype=torch.int32, device=device)
        logits, rows = bundle.prefill_paged(params, {"tokens": tokens,
                                                     "lens": lens})
        del logits, rows
    if device.type == "cuda":
        torch.cuda.synchronize()


def check(torch, cell: S.Cell, conf: Dict[str, Any], seed: int, params,
          engine, probe: Probe, rec: L.Record, precs) -> C.Readings:
    """The comparison with the family's plain reference (``check.py``),
    once the window has closed, with TF32 off and the engine's state
    freed."""
    ref = S.reference_module(conf["family"])
    rng = traffic.rng_for(int(seed) ^ CHECK_SALT)
    sample = cell.limits.get("sample", {})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine.cache = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if conf["family"] != "moe":
        per = int(sample.get("per_request", 100))
        return C.teacher_forced(
            ref, params, conf,
            C.finished_sample(rec, rng, int(sample.get("tokens", 400)),
                              int(sample.get("max_requests", 4)), per),
            per, precs)
    snap = probe.snap
    if snap is None:
        raise RuntimeError("no decode step over a full batch ran in the "
                           "window's second half")
    tie = float(cell.limits.get("tie_margin", 0.0))
    pick = C.sample_in_flight(snap, rng, int(sample.get("max_requests", 8)))
    slots = len(snap.slots)
    if slots > ref.capacity(slots, conf):
        decodes = C.follow_decode(ref, params, conf, snap, tie, precs)
    else:
        decodes = C.follow_decodes(ref, params, conf, snap, pick, tie,
                                   precs)
    return C.merge(
        decodes,
        C.follow_prefills(ref, params, conf, snap, probe.prefills, pick,
                          tie, precs),
        C.first_layer_rows(ref, params, conf, snap, precs))


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", control: bool = False,
             config: Optional[Dict[str, Any]] = None,
             mix: Optional[Dict[str, Any]] = None,
             patch: Optional[Callable] = None) -> Dict[str, Any]:
    """One run; returns the result's fields (without ``device``'s card
    readings when ``device`` is the CPU, which only the tests use)."""
    import torch
    from repro_torch import _build
    from repro_torch.device import torch_dtype
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine, \
        ServeRequest

    conf = dict(cell.config, **(config or {}))
    mix = dict(cell.mix, **(mix or {}))
    traffic.check_mix(mix)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mcfg = model_config(conf)
    if on_card:
        built = _build.build(KERNELS[mcfg.family])
        if built:
            log(f"[setup] built {sorted(built)} in "
                f"{max(built.values()):.1f} s")
    bundle = build_model(mcfg)
    dtype = torch_dtype(mcfg.dtype)
    params = draw_params(conf, seed, dev, dtype)
    spans = T.Spans() if trace else None
    block_size = 16
    probe = Probe(bundle, spans, block_size)
    engine = ServeEngine(bundle, params, EngineConfig(
        slots=int(mix["clients"]), cache_len=int(mix["cache_len"]),
        paged=True, block_size=block_size,
        max_prefill_batch=int(mix.get("max_prefill_batch", 8))),
        device=dev)
    probe.attach(engine)
    if patch is not None:
        patch(bundle, engine)
    with torch.no_grad():
        warm_up(torch, bundle, params, mix, dev)
    probe.prefills.clear()
    loop = L.ClosedLoop(
        engine, traffic.requests(mix, seed, mcfg.vocab_size),
        int(mix["clients"]),
        lambda i, d: ServeRequest(rid=i, prompt=d.prompt, max_new=d.max_new))
    prof = T.Profiler(torch) if trace and on_card else None
    if prof is not None:
        prof.warm()
    traced_from = [1 << 62]

    def on_tick(t: float) -> None:
        if prof is not None and prof.prof is None and not prof.t0 \
                and t - loop.rec.t_open >= seconds - TRACE_S:
            traced_from[0] = time.perf_counter_ns()
            prof.start()

    with torch.no_grad():
        loop.start()
        loop.tick()                       # the first prefills: set-up
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        probe.snap_after = time.perf_counter() + seconds / 2
        use0, load0 = resource.getrusage(resource.RUSAGE_SELF), \
            os.getloadavg()[0]
        loop.run_window(seconds, on_tick)
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        dtrace = prof.stop() if prof is not None and prof.prof else None
    rec = loop.rec
    attempted, failed = L.attempted_failed(rec)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"[run] {cell.name} seed {seed}: {len(rec.ticks)} ticks, window "
        f"{L.window_s(rec):.3f} s, {L.output_tokens(rec)} tokens out, "
        f"{attempted} requests sent ({failed} failed), "
        f"{n_params(params) / 1e9:.3f} B params, peak "
        f"{peak / 1e9:.2f} GB, set-up {setup_s:.2f} s; "
        f"engine {engine.stats()}")
    # the host under the loop: how much of the window this process ran on
    # a core, how often it was made to wait for one, the machine's load
    cpu = use1.ru_utime + use1.ru_stime - use0.ru_utime - use0.ru_stime
    log(f"[host] window {L.window_s(rec):.3f} s, process cpu "
        f"{cpu:.3f} s ({cpu / L.window_s(rec):.4f} of the window), "
        f"involuntary switches {use1.ru_nivcsw - use0.ru_nivcsw}, "
        f"voluntary {use1.ru_nvcsw - use0.ru_nvcsw}, load "
        f"{load0:.2f} -> {os.getloadavg()[0]:.2f} on {os.cpu_count()} "
        f"cores; snapshot {probe.snap_ms:.2f} ms at step "
        f"{probe.snap.step if probe.snap else None}, "
        f"{(probe.snap.nbytes() if probe.snap else 0) / 1e9:.3f} GB")

    out: Dict[str, Any] = {"attempted": attempted, "failed": failed,
                           "peak": peak, "setup_s": setup_s}
    metrics: Dict[str, Any] = {}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m.name == "setup_s" \
                else L.END_TO_END[m.name](rec)
            metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        ctx = Context(cfg=conf, rec=rec, spans=spans, trace=dtrace,
                      traced_from_ns=traced_from[0], block_size=block_size,
                      lens=_host_lens(torch, spans))
        for m in cell.per_layer:
            value = S.metric_reader(m.name).read(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        if dtrace is not None:
            out["busy_s"] = dtrace.busy_s()
            out["window_s"] = dtrace.window_s
            out["breakdown"] = {"device_ops": T.top_ops(dtrace),
                                "idle_gaps": T.idle_by_span(dtrace, spans)}
            log(f"[trace] {len(dtrace.ops)} device ops in "
                f"{dtrace.window_s:.3f} s, busy {out['busy_s']:.3f} s")
    out["metrics"] = metrics

    # ---- the check, after the window, on freed program state ----------
    t_check = time.perf_counter()
    precs = ("f32", "fp8") if control else ("f32",)
    error = None
    try:
        with torch.no_grad():
            readings = check(torch, cell, conf, seed, params, engine, probe,
                             rec, precs)
    except (RuntimeError, IndexError, ValueError) as e:
        error = f"{type(e).__name__}: {e}"
        readings = C.Readings()
    log("[check-detail] " + json.dumps(readings.detail))
    for prec in precs:
        log(f"[check-read] {prec} {json.dumps(readings.numbers(prec))}")
    correct, checks = C.judge(readings, cell.limits)
    out["check_s"] = time.perf_counter() - t_check
    out["correct"] = correct
    out["checks"] = checks
    out["compared_tokens"] = readings.tokens
    if control:
        out["control"] = C.judge(readings, cell.limits, "fp8")[1]
    if error:
        out["check_error"] = error
    return out
