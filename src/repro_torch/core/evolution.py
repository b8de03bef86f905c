"""The hardware-aware evolutionary NAS loop (paper §III-A, §VI).

Counterpart of ``repro/core/evolution.py``: the same loop, with the
port's trainers, scheduler and numpy copies.  The one API difference is
``EvolutionarySearch(..., device=None)``: ``None`` means the card, and the
device is threaded into the default scalar and batched trainers.  The
checkpoint format is the reference's JSON, so a checkpoint written by
either package resumes in the other.

Per generation (paper: 100 generations x 20 children on 4 GPUs):

1. sample parents from the population, inverse-KDE-density weighted in
   cheap-objective space (LEMONADE-style exploration of the frontier);
2. produce children by forced-active mutation (+ occasional crossover);
   phenotype-hash dedup implements the dormant-gene shortcut — children whose
   expressed genes are unchanged are never retrained;
3. evaluate the children's cheap objectives analytically (Eqs. 1-4);
4. **two-step preselection**: only ``n_accept`` children, chosen
   inverse-density in cheap space, get expensive evaluation (training) —
   dispatched through the dynamic workload scheduler;
5. environmental selection (non-dominated sort + crowding) trims the merged
   population back to capacity.

The loop is array-resident (DESIGN.md §8): the population lives as a
struct-of-arrays :class:`~repro_torch.core.objectives.PopulationArrays`, children
are produced by the vectorized genetic operators
(:func:`~repro_torch.core.genome.mutate_batch` / ``crossover_batch``), and
:class:`~repro_torch.core.objectives.Candidate` objects are materialized only for
the ``n_accept`` children handed to the trainer (and at the
checkpoint/report edges).

Orchestration (DESIGN.md §11): training dispatches through a device-affine
:class:`~repro_torch.core.scheduler.DynamicScheduler` — one worker group per
visible accelerator, so different signature buckets of a generation train
concurrently on different devices — and ``NASConfig.pipeline`` selects how
much of the loop overlaps with the devices:

* ``"off"`` — the fully synchronous loop (dispatch, block, select).
* ``"host_overlap"`` — training is submitted asynchronously and the host
  folds the merged population's *cheap* domination columns
  (:class:`~repro_torch.core.pareto.PartialDomination`) while the devices train,
  finishing with the expensive columns when results land.  No extra RNG
  draws and a bit-identical domination matrix: the trajectory equals the
  synchronous loop's exactly.
* ``"async"`` — steady-state pipelining: generation N+1's children are
  mutated/cheap-scored/dispatched while generation N still trains (bounded
  by ``NASConfig.lookahead``), and trained results are admitted into the
  dormant-gene cache as each bucket lands (the scheduler's ``on_result``
  hook).  Relaxed semantics — selection folds a generation in only when it
  drains, so parents lag the newest results; the trajectory differs from
  the synchronous loop and the mode is opt-in.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from collections import deque
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from repro_torch.core import selection as sel
from repro_torch.core.cost_backend import (BackendSpec, backend_schema,
                                           get_backend)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.genome import (
    Genome,
    PopulationEncoding,
    crossover_batch,
    mutate_batch,
    random_population,
)
from repro_torch.core.hw_model import FPGA_ZU, HardwareProfile
from repro_torch.core.objective_schema import (
    Constraints,
    DesignGoal,
    ObjectiveSchema,
    get_goal,
    pessimistic_expensive,
)
from repro_torch.core.objectives import (
    Candidate,
    PopulationArrays,
    expensive_objectives,
)
from repro_torch.core.pareto import (
    PartialDomination,
    domination_matrices,
    domination_matrix,
    environmental_selection,
    pareto_front,
)
from repro_torch.core.scheduler import (DynamicScheduler, JobResult,
                                        SchedulerRun)
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.core.trainer import TrainResult, train_candidate
from repro_torch.core.trainer_batch import (
    bucket_by_signature,
    train_candidates_batched,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import local_search_devices

PIPELINE_MODES = ("off", "host_overlap", "async")

# max/min per-device busy ratio above which a generation's training jobs
# are considered skewed enough to flag (device-affine bucket sharding can
# pin all the big signature buckets to one device — DESIGN.md §11)
DEVICE_IMBALANCE_RATIO = 2.0


def device_imbalance(device_busy: Dict[str, float],
                     *, min_busy_s: float = 1e-3) -> Optional[float]:
    """Max/min busy-time ratio across devices for one generation, or
    ``None`` when imbalance is meaningless (fewer than 2 devices, or the
    generation did next to no device work).  A device that stayed (almost)
    idle while others trained reports ``inf`` — the worst skew."""
    if len(device_busy) < 2:
        return None
    busy = sorted(device_busy.values())
    if busy[-1] < min_busy_s:
        return None
    if busy[0] < min_busy_s:
        return float("inf")
    return busy[-1] / busy[0]


@dataclasses.dataclass
class NASConfig:
    generations: int = 100
    children_per_gen: int = 20
    n_accept: int = 8              # expensive-evaluation budget per generation
    population_cap: int = 64
    init_population: int = 16
    mutation_rate: float = 0.1
    crossover_prob: float = 0.25
    train_steps: int = 300
    train_batch: int = 64
    lr: float = 3e-3
    n_workers: int = 4
    seed: int = 0
    profile: HardwareProfile = FPGA_ZU
    backend: Optional[BackendSpec] = None  # cost backend; default = profile
    backends: Optional[Sequence[BackendSpec]] = None  # multi-platform: one
    #   population scored against K platforms (MultiPlatformBackend)
    goal: Union[str, DesignGoal] = "balanced"  # deployment design goal —
    #   selects/weights schema columns for selection + the final report
    det_min: float = 0.90          # paper's hard acceptance limits
    fa_max: float = 0.20
    batch_training: bool = True    # bucketed, stacked training (§9)
    pipeline: str = "off"          # "off" | "host_overlap" | "async" (§11)
    device_affinity: Optional[bool] = None  # shard signature buckets across
    #   local_search_devices(); None = auto (on for batched training when >1
    #   card is visible), False = force single-device dispatch
    lookahead: int = 1             # async mode: generations produced ahead
    #   of the oldest still-training one (max lookahead+1 in flight)
    ckpt_every: Optional[int] = None  # run_resumable: generations between
    #   checkpoints.  None = 1 for the deterministic pipelines, and
    #   lookahead+1 for async (each checkpoint is a drain barrier: stop
    #   admitting lookahead work, drain in flight, persist — DESIGN.md §13)

    @property
    def constraints(self) -> Constraints:
        return Constraints(self.det_min, self.fa_max)


@dataclasses.dataclass
class NASState:
    pop: PopulationArrays
    generation: int
    evaluated_hashes: Dict[str, np.ndarray]  # phenotype hash -> expensive objs
    history: List[dict]

    @property
    def population(self) -> List[Candidate]:
        """Materialized object view of the population (reports, tests).

        The resident representation is the struct-of-arrays ``pop``; this
        property builds fresh :class:`Candidate` objects on every access —
        mutating them does not write back.
        """
        return self.pop.to_candidates()


@dataclasses.dataclass
class _TrainPlan:
    """Rows of a population slated for training (cache misses only)."""
    todo: List[int]
    genomes: List[Genome]


@dataclasses.dataclass
class _TrainSubmission:
    """An in-flight training dispatch: the scheduler run plus the job →
    candidate alignment needed to scatter results back."""
    run: SchedulerRun
    n_jobs: int
    buckets: Optional[List[List[int]]]   # None = one job per candidate
    n_genomes: int


class EvolutionarySearch:
    """Reusable search loop; inject a trainer for tests."""

    def __init__(self, config: NASConfig,
                 data_train, data_val,
                 space: SearchSpace = DEFAULT_SPACE,
                 train_fn: Optional[Callable[[Genome], TrainResult]] = None,
                 batch_train_fn: Optional[
                     Callable[[List[Genome]], List[TrainResult]]] = None,
                 log: Callable[[str], None] = print,
                 faults: Optional[FaultPlan] = None,
                 device: DeviceLike = None):
        self.cfg = config
        # where the default trainers train and evaluate (None: the card)
        self.device = resolve_device(device)
        # fault injection (DESIGN.md §13): an explicit, seeded plan wired
        # through the scheduler / training-result / checkpoint / generation
        # inject points; None (production) leaves every hook inert
        self.faults = faults
        if config.pipeline not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {config.pipeline!r} "
                             f"(modes: {PIPELINE_MODES})")
        self.space = space
        self.rng = np.random.default_rng(config.seed)
        if config.backends is not None:
            if config.backend is not None:
                raise ValueError("NASConfig.backend and NASConfig.backends "
                                 "are mutually exclusive")
            self.backend = get_backend(list(config.backends))
        else:
            self.backend = get_backend(config.backend if config.backend
                                       is not None else config.profile)
        # the objective layer is schema-described (DESIGN.md §10): cheap
        # columns from the backend, + the expensive pair for selection
        self.schema: ObjectiveSchema = backend_schema(self.backend)
        self.full_schema: ObjectiveSchema = self.schema.with_expensive()
        # the pessimistic placeholder row (failed/unevaluated candidates) is
        # schema-derived: width and worst-case values follow the expensive
        # columns instead of a hard-coded 2-vector
        self._exp_worst: np.ndarray = pessimistic_expensive(self.full_schema)
        self.goal: DesignGoal = get_goal(config.goal)
        self.constraints: Constraints = self.goal.effective_constraints(
            config.constraints)
        # goal-conditioned column views; None = all columns (the balanced
        # default — bit-identical to the pre-schema engine)
        sel_cols = self.goal.selection_indices(self.full_schema)
        self._goal_cols = None if len(sel_cols) == len(self.full_schema) \
            else sel_cols
        # the cheap part of the selection view — the host-overlap pipeline
        # folds these domination columns while the devices train
        self._sel_cheap_cols = sel_cols[sel_cols < len(self.schema)]
        kde_cols = self._sel_cheap_cols
        self._kde_cols = None if len(kde_cols) == len(self.schema) \
            else kde_cols
        self.log = log
        self._train_fn = train_fn or (lambda g: train_candidate(
            g, data_train, data_val, space=self.space,
            steps=config.train_steps, batch_size=config.train_batch,
            lr=config.lr, seed=config.seed, device=self.device))
        # bucketed, stacked training (DESIGN.md §9): the default unless
        # a scalar train_fn is injected (tests) or the config opts out.
        if batch_train_fn is not None:
            self._batch_train_fn = batch_train_fn
        elif train_fn is None and config.batch_training:
            stage_cache: Dict[tuple, tuple] = {}  # device dataset, per search
            self._batch_train_fn = lambda gs, device=None: \
                train_candidates_batched(
                    gs, data_train, data_val, space=self.space,
                    steps=config.train_steps, batch_size=config.train_batch,
                    lr=config.lr, seed=config.seed, stage_cache=stage_cache,
                    device=self.device if device is None else device)
        else:
            self._batch_train_fn = None
        self._batch_fn_takes_device = self._fn_takes_device(
            self._batch_train_fn)
        # device-affine scheduling (DESIGN.md §11): one worker group per
        # visible accelerator so signature buckets train concurrently on
        # different devices.  Auto mode stays off for scalar trainers (they
        # cannot place their data), on single-card hosts and for a search
        # on the CPU — all fall back to the plain thread pool.
        self.devices: Optional[List[Any]] = None
        affinity = config.device_affinity
        if affinity is None:
            affinity = self._batch_train_fn is not None
        if affinity and self.device.type == "cuda":
            devs = local_search_devices()
            if len(devs) > 1:
                self.devices = devs
        n_workers = config.n_workers if self.devices is None \
            else max(config.n_workers, len(self.devices))
        self.scheduler = DynamicScheduler(n_workers=n_workers,
                                          max_retries=2, timeout_s=1800.0,
                                          devices=self.devices,
                                          faults=faults,
                                          seed=config.seed)
        # guards evaluated_hashes: the async pipeline's on_result hook
        # admits results from scheduler worker threads
        self._cache_lock = threading.Lock()

    @staticmethod
    def _poison_result(value):
        """Injected-divergence payload: the result's loss goes non-finite
        (the quarantine path then treats it exactly like a real NaN)."""
        try:
            return dataclasses.replace(value, val_loss=float("nan"))
        except TypeError:
            return value

    @staticmethod
    def _fn_takes_device(fn) -> bool:
        if fn is None:
            return False
        try:
            params = inspect.signature(fn).parameters.values()
        except (TypeError, ValueError):
            return False
        return any(p.name == "device" or p.kind == p.VAR_KEYWORD
                   for p in params)

    # ------------------------------------------------------------- lifecycle
    def _sample_unique(self, n: int
                       ) -> Tuple[PopulationEncoding, List[str]]:
        """``n`` random valid genomes with pairwise-distinct phenotypes."""
        parts: List[PopulationEncoding] = []
        hashes: List[str] = []
        seen = set()
        while len(hashes) < n:
            enc = random_population(self.rng, n - len(hashes), self.space)
            keep = []
            for i, h in enumerate(enc.batch_phenotype_hash(self.space)):
                if h in seen:
                    continue
                seen.add(h)
                keep.append(i)
                hashes.append(h)
            if keep:
                parts.append(enc.take(keep))
        return PopulationEncoding.concatenate(parts), hashes

    def _score(self, enc: PopulationEncoding, hashes: Sequence[str],
               generation: int) -> PopulationArrays:
        """One batched cheap-objective pass — the only cheap evaluation in a
        generation step (the matrix is cached on the PopulationArrays)."""
        return PopulationArrays(
            enc=enc,
            cheap=self.backend.evaluate_batch(enc, space=self.space),
            expensive=np.full((len(enc), len(self._exp_worst)), np.nan),
            phash=np.asarray(hashes, dtype=object),
            born=np.full(len(enc), generation, dtype=np.int64),
            schema=self.schema)

    def init_state(self) -> NASState:
        enc, hashes = self._sample_unique(self.cfg.init_population)
        state = NASState(pop=self._score(enc, hashes, generation=0),
                         generation=0, evaluated_hashes={}, history=[])
        self._train_members(state, state.pop, np.arange(len(state.pop)))
        return state

    # ---------------------------------------------------------------- steps
    def _spawn_children(self, state: NASState,
                        extra_seen: Optional[set] = None
                        ) -> Optional[Tuple[PopulationEncoding, List[str]]]:
        """Mutation/crossover + dormant-gene dedup; returns the child gene
        arrays and phenotype hashes (``None`` if every child was a known
        phenotype).  ``extra_seen`` adds hashes to dedup against — the
        async pipeline's still-training generations."""
        pop = state.pop
        parents_idx = sel.sample_parents(self.rng, pop.cheap,
                                         self.cfg.children_per_gen,
                                         cols=self._kde_cols)
        parents = pop.enc.take(parents_idx)
        if len(pop) > 1:
            xo = self.rng.random(len(parents_idx)) < self.cfg.crossover_prob
        else:
            xo = np.zeros(len(parents_idx), dtype=bool)
        parts: List[PopulationEncoding] = []
        if xo.any():
            mates = pop.enc.take(
                self.rng.integers(0, len(pop), int(xo.sum())))
            crossed = crossover_batch(parents.take(np.nonzero(xo)[0]), mates,
                                      self.rng, self.space)
            parts.append(mutate_batch(crossed, self.rng, self.space,
                                      rate=self.cfg.mutation_rate,
                                      force_active_change=False))
        if not xo.all():
            parts.append(mutate_batch(parents.take(np.nonzero(~xo)[0]),
                                      self.rng, self.space,
                                      rate=self.cfg.mutation_rate,
                                      force_active_change=True))
        children = PopulationEncoding.concatenate(parts)
        # dormant-gene shortcut: drop children whose expressed genes match a
        # population member or an earlier sibling
        hashes = children.batch_phenotype_hash(self.space)
        seen = set(pop.phash)
        if extra_seen:
            seen |= extra_seen
        keep: List[int] = []
        kept_hashes: List[str] = []
        for i, h in enumerate(hashes):
            if h in seen:
                continue
            seen.add(h)
            keep.append(i)
            kept_hashes.append(h)
        if not keep:
            return None
        return children.take(keep), kept_hashes

    def _make_children(self, state: NASState
                       ) -> Optional[PopulationArrays]:
        spawned = self._spawn_children(state)
        if spawned is None:
            return None
        return self._score(spawned[0], spawned[1],
                           generation=state.generation + 1)

    # ------------------------------------------------- training dispatch
    def _call_batch_train(self, genomes: List[Genome], device):
        """Invoke the batch trainer, forwarding the worker's device when
        the trainer can place data on it (injected test doubles often
        can't — they simply ignore affinity)."""
        if device is not None and self._batch_fn_takes_device:
            return self._batch_train_fn(genomes, device=device)
        return self._batch_train_fn(genomes)

    def _plan_training(self, state: NASState, pop: PopulationArrays,
                       idx: np.ndarray) -> Optional[_TrainPlan]:
        """Resolve dormant-gene cache hits for rows ``idx`` of ``pop``
        (writing their expensive objectives immediately); the returned plan
        lists the rows that genuinely need training (``None`` if none)."""
        todo: List[int] = []
        with self._cache_lock:
            for i in idx:
                cached = state.evaluated_hashes.get(str(pop.phash[i]))
                if cached is not None:  # cache hit (dormant genes)
                    pop.expensive[i] = cached
                else:
                    todo.append(int(i))
        if not todo:
            return None
        return _TrainPlan(todo=todo,
                          genomes=[pop.enc.genome(i) for i in todo])

    def _submit_training(self, genomes: List[Genome],
                         phashes: Optional[List[str]] = None,
                         admit: Optional[Callable[[str, np.ndarray], None]]
                         = None) -> _TrainSubmission:
        """Dispatch training through the scheduler without blocking: one
        job per signature bucket when batched training is on (retry/
        speculation then operate on buckets — a failed bucket re-dispatches
        whole), else one job per candidate.  ``admit`` (with ``phashes``)
        is called per successful candidate as each bucket lands — the async
        pipeline's early-admission hook."""
        if self._batch_train_fn is None:
            buckets = None
            jobs = [(lambda device=None, g=g: self._train_fn(g))
                    for g in genomes]
        else:
            buckets = list(bucket_by_signature(genomes, self.space).values())
            jobs = [(lambda device=None, rows=rows: self._call_batch_train(
                [genomes[j] for j in rows], device)) for rows in buckets]
        on_result = None
        if admit is not None and phashes is not None:
            def on_result(r: JobResult) -> None:
                # runs under the scheduler lock in a worker thread — only
                # successful, well-formed results are admitted early; the
                # blocking collect handles failures/pessimism
                if not r.ok or r.value is None:
                    return
                rows = buckets[r.job_id] if buckets is not None \
                    else [r.job_id]
                vals = r.value if buckets is not None else [r.value]
                try:
                    if len(vals) != len(rows):
                        return
                except TypeError:
                    return
                for k, j in enumerate(rows):
                    exp = expensive_objectives(vals[k])
                    vl = getattr(vals[k], "val_loss", 0.0)
                    # never admit a diverged (non-finite) result early: the
                    # blocking collect quarantines it with the pessimistic
                    # row, and a poisoned cache entry would leak into later
                    # generations' dormant-gene lookups
                    if np.all(np.isfinite(exp)) and np.isfinite(vl):
                        admit(phashes[j], exp)
        # bucket sizes turn on the scheduler's largest-first dispatch, so
        # device busy times stay level (the device_busy_s rebalancing
        # signal, DESIGN.md §11/§13)
        sizes = [len(rows) for rows in buckets] \
            if buckets is not None else None
        return _TrainSubmission(run=self.scheduler.submit(jobs, on_result,
                                                          sizes=sizes),
                                n_jobs=len(jobs), buckets=buckets,
                                n_genomes=len(genomes))

    def _collect_training(self, sub: _TrainSubmission
                          ) -> Tuple[List[JobResult], List[JobResult]]:
        """Block on a submission; returns (per-candidate results in genome
        order, raw per-job results).  The scheduler may return partial
        results (every worker died), so jobs are matched by job_id and the
        gaps marked failed instead of mispairing zip order."""
        by_id = {r.job_id: r for r in sub.run.wait()}
        raw = [by_id.get(i, JobResult(job_id=i, ok=False,
                                      error="no result (workers died)"))
               for i in range(sub.n_jobs)]
        if sub.buckets is None:
            return raw, raw
        out: List[Optional[JobResult]] = [None] * sub.n_genomes
        for rows, br in zip(sub.buckets, raw):
            ok = bool(br.ok and br.value is not None
                      and len(br.value) == len(rows))
            error = br.error if not br.ok else (
                "" if ok else "batch trainer returned misaligned results")
            for k, j in enumerate(rows):
                out[j] = JobResult(
                    job_id=j, ok=ok,
                    value=br.value[k] if ok else None,
                    error=error, attempts=br.attempts,
                    elapsed_s=br.elapsed_s, worker=br.worker,
                    device=br.device)
        return out, raw  # type: ignore[return-value]

    def _finish_training(self, state: NASState, pop: PopulationArrays,
                         plan: _TrainPlan, sub: _TrainSubmission
                         ) -> Dict[str, float]:
        """Wait on a submission, write expensive objectives (pessimistic on
        failure OR divergence) into ``pop`` + the dormant-gene cache, and
        return the per-device busy time of the dispatched jobs."""
        results, raw = self._collect_training(sub)
        if sub.run.quarantined:
            self.log(f"[nas] WARNING: quarantined device(s) "
                     f"{[str(d) for d in sub.run.quarantined]} after "
                     f"repeated failures — queued buckets rebalanced onto "
                     f"the surviving devices")
        for i, r in zip(plan.todo, results):
            if self.faults is not None:
                spec = self.faults.fire("trainer.result",
                                        phash=str(pop.phash[i]),
                                        generation=state.generation)
                if spec is not None and spec.kind == "nonfinite" and r.ok:
                    r = dataclasses.replace(
                        r, value=self._poison_result(r.value))
            if r.ok:
                exp = expensive_objectives(r.value)
                vl = getattr(r.value, "val_loss", 0.0)
                if not (np.all(np.isfinite(exp)) and np.isfinite(vl)):
                    # per-candidate quarantine: a diverged candidate gets
                    # the schema-pessimistic row; its bucket-mates' results
                    # (already in `results`) are untouched
                    self.log(f"[nas] candidate {pop.phash[i]} diverged "
                             f"(non-finite objectives) — quarantined with "
                             f"pessimistic row")
                    exp = self._exp_worst.copy()
            else:  # failed after retries: pessimistic objectives, stay in
                self.log(f"[nas] candidate {pop.phash[i]} failed: "
                         f"{r.error.splitlines()[-1] if r.error else '?'}")
                exp = self._exp_worst.copy()
            pop.expensive[i] = exp
            with self._cache_lock:
                state.evaluated_hashes[str(pop.phash[i])] = exp
        busy: Dict[str, float] = {}
        for r in raw:
            key = str(r.device) if r.device is not None else "default"
            busy[key] = busy.get(key, 0.0) + r.elapsed_s
        return busy

    def _train_members(self, state: NASState, pop: PopulationArrays,
                       idx: np.ndarray) -> Dict[str, float]:
        """Expensive-evaluate rows ``idx`` of ``pop`` (cache-first),
        blocking until every result is in.  Returns per-device busy time.
        Genome objects are materialized here only, for the training jobs."""
        plan = self._plan_training(state, pop, idx)
        if plan is None:
            return {}
        return self._finish_training(state, pop, plan,
                                     self._submit_training(plan.genomes))

    # ------------------------------------------------------ selection fold
    def _goal_objs(self, merged: PopulationArrays) -> np.ndarray:
        """The goal-conditioned objective view (all columns for the
        balanced default — bit-identical to the pre-schema engine)."""
        objs = merged.objective_matrix()
        if self._goal_cols is not None:
            objs = objs[:, self._goal_cols]
        return objs

    def _select_and_record(self, state: NASState, merged: PopulationArrays,
                           objs: np.ndarray, dom: np.ndarray,
                           n_children: int, n_trained: int,
                           timings: Dict[str, float],
                           device_busy: Dict[str, float],
                           train_jobs: int,
                           pipeline: Optional[str] = None,
                           t0: Optional[float] = None) -> None:
        """Environmental selection + the per-generation history record.
        One domination matrix serves both the environmental selection and
        the kept population's front-size report."""
        t_sel = time.monotonic()
        keep = environmental_selection(objs, self.cfg.population_cap,
                                       dom=dom)
        new_pop = merged.take(keep)
        gen = state.generation + 1
        front = pareto_front(objs[keep], dom=dom[np.ix_(keep, keep)])
        feasible = new_pop.feasible_mask(self.constraints)
        primary = self.goal.primary_indices(self.schema)
        timings["select"] = time.monotonic() - t_sel
        rec = {
            "generation": gen,
            "children": n_children,
            "trained": n_trained,
            "population": len(new_pop),
            "front_size": int(len(front)),
            "feasible": int(feasible.sum()),
            # worst-across-platforms primary objective of the best feasible
            # member (single platform: just its primary objective)
            "best_primary": float(
                new_pop.cheap[np.ix_(feasible, primary)].max(axis=1).min())
            if feasible.any() else float("nan"),
            "elapsed_s": time.monotonic() - (t0 if t0 is not None else t_sel),
            # wall-time split of the generation's phases + per-device busy
            # time of its training jobs (DESIGN.md §11) — how much overlap
            # the pipeline actually achieved is observable per generation
            "timings": dict(timings),
            "device_busy_s": dict(device_busy),
            "train_jobs": train_jobs,
        }
        if pipeline is not None:
            rec["pipeline"] = pipeline
        imb = device_imbalance(device_busy)
        if imb is not None and imb > DEVICE_IMBALANCE_RATIO:
            rec["device_imbalance"] = imb
            busy_fmt = {k: round(v, 3)
                        for k, v in sorted(device_busy.items())}
            self.log(f"[nas] WARNING gen {gen}: device busy "
                     f"imbalance {imb:.1f}x (max/min, threshold "
                     f"{DEVICE_IMBALANCE_RATIO:.1f}x) — signature buckets "
                     f"are skewing onto few devices; busy={busy_fmt}")
        # publish the finished generation as one cut: everything above
        # worked on locals, so a preemption mid-selection leaves `state` at
        # the previous consistent generation (DESIGN.md §13)
        state.pop, state.generation = new_pop, gen
        state.history.append(rec)
        self.log(f"[nas] gen {rec['generation']:3d} "
                 f"pop={rec['population']} front={rec['front_size']} "
                 f"feasible={rec['feasible']} "
                 f"best[{self.goal.primary}]={rec['best_primary']:.3e} "
                 f"({rec['elapsed_s']:.1f}s)")

    def step(self, state: NASState) -> NASState:
        """One generation.  ``pipeline="off"`` dispatches and blocks;
        ``"host_overlap"`` (and ``"async"``, which degenerates to it for a
        single step — cross-generation pipelining needs :meth:`run`) folds
        the merged population's cheap domination columns while the devices
        train.  Both orderings produce bit-identical trajectories."""
        t0 = time.monotonic()
        timings: Dict[str, float] = {}
        spawned = self._spawn_children(state)
        timings["children"] = time.monotonic() - t0
        t = time.monotonic()
        children = None if spawned is None else self._score(
            spawned[0], spawned[1], generation=state.generation + 1)
        timings["cheap_score"] = time.monotonic() - t

        overlap = self.cfg.pipeline in ("host_overlap", "async")
        device_busy: Dict[str, float] = {}
        train_jobs = 0
        t = time.monotonic()
        if children is not None:
            acc_idx = sel.preselect_children(self.rng, state.pop.cheap,
                                             children.cheap,
                                             self.cfg.n_accept,
                                             cols=self._kde_cols)
            accepted = children.take(acc_idx)
            n_children, n_trained = len(children), len(accepted)
            if overlap:
                plan = self._plan_training(state, accepted,
                                           np.arange(len(accepted)))
                sub = None if plan is None \
                    else self._submit_training(plan.genomes)
                # ---- overlap window: while the devices train, fold the
                # merged population's cheap domination columns (boolean
                # folds are order-independent — the finished matrix is
                # bit-identical to the synchronous one)
                merged_cheap = np.concatenate([state.pop.cheap,
                                               accepted.cheap])
                partial = PartialDomination(
                    merged_cheap[:, self._sel_cheap_cols])
                # ---- join: write results, then fold the expensive columns
                if sub is not None:
                    device_busy = self._finish_training(state, accepted,
                                                        plan, sub)
                    train_jobs = sub.n_jobs
                timings["train"] = time.monotonic() - t
                merged = PopulationArrays.concat([state.pop, accepted])
                objs = self._goal_objs(merged)
                dom = partial.finish(objs[:, len(self._sel_cheap_cols):])
            else:
                plan = self._plan_training(state, accepted,
                                           np.arange(len(accepted)))
                if plan is not None:
                    sub = self._submit_training(plan.genomes)
                    device_busy = self._finish_training(state, accepted,
                                                        plan, sub)
                    train_jobs = sub.n_jobs
                timings["train"] = time.monotonic() - t
                merged = PopulationArrays.concat([state.pop, accepted])
                objs = self._goal_objs(merged)
                dom = domination_matrix(objs)
        else:
            timings["train"] = 0.0
            merged = state.pop
            n_children = n_trained = 0
            objs = self._goal_objs(merged)
            dom = domination_matrix(objs)

        self._select_and_record(state, merged, objs, dom, n_children,
                                n_trained, timings, device_busy, train_jobs,
                                t0=t0)
        return state

    def run(self, generations: Optional[int] = None) -> NASState:
        gens = generations or self.cfg.generations
        if self.cfg.pipeline == "async":
            return self._run_async(gens)
        state = self.init_state()
        for _ in range(gens):
            if self.faults is not None:
                self.faults.fire("search.generation",
                                 generation=state.generation)
            state = self.step(state)
        return state

    # --------------------------------------------------- async pipelining
    def _run_async(self, generations: int,
                   state: Optional[NASState] = None,
                   ckpt_path: Optional[str] = None) -> NASState:
        """Steady-state pipelined evolution (``pipeline="async"``).

        Generation N+1's children are mutated, cheap-scored, preselected
        and *dispatched* while generation N's buckets still train — up to
        ``lookahead + 1`` generations in flight.  Each bucket's results are
        admitted into the dormant-gene cache the moment it lands (the
        scheduler's ``on_result`` hook), so later generations never
        retrain a phenotype that finished early; environmental selection
        folds a generation into the population only when it drains, in
        submission order.  Relaxed semantics: parents of generation N+1
        are sampled from the population *before* generation N's survivors
        joined it — the price of never letting the host or the devices
        idle.

        With ``ckpt_path`` the loop checkpoints at *drain barriers*
        (DESIGN.md §13): every ``ckpt_every`` produced generations
        (default ``lookahead + 1``) it stops admitting lookahead work,
        drains every in-flight generation, and persists the then-consistent
        :class:`NASState` — the pipeline refills afterwards.  A search
        resumed from such a cut re-enters with an empty pipeline, exactly
        the state an uninterrupted barrier run had at that point."""
        if state is None:
            state = self.init_state()
        target = state.generation + generations
        produced = state.generation
        saved_gen = state.generation  # run_resumable persisted this cut
        barrier = self.cfg.ckpt_every or (self.cfg.lookahead + 1)
        next_barrier = (state.generation + barrier) \
            if ckpt_path is not None else None

        def admit(phash: str, exp: np.ndarray) -> None:
            with self._cache_lock:
                state.evaluated_hashes[phash] = exp

        empty = state.pop.take(np.asarray([], dtype=np.int64))
        inflight: Deque[dict] = deque()
        inflight_hashes: set = set()
        t_drain = time.monotonic()

        def drain() -> None:
            nonlocal t_drain
            entry = inflight.popleft()
            accepted = entry["accepted"]
            timings = entry["timings"]
            device_busy: Dict[str, float] = {}
            t = time.monotonic()
            if entry["sub"] is not None:
                device_busy = self._finish_training(
                    state, accepted, entry["plan"], entry["sub"])
            timings["train"] = time.monotonic() - t  # wait-time only: the
            #   bucket trained while later generations were produced
            inflight_hashes.difference_update(str(h) for h in accepted.phash)
            merged = PopulationArrays.concat([state.pop, accepted]) \
                if len(accepted) else state.pop
            objs = self._goal_objs(merged)
            dom = domination_matrix(objs)
            self._select_and_record(
                state, merged, objs, dom, entry["n_children"],
                len(accepted), timings, device_busy,
                entry["sub"].n_jobs if entry["sub"] is not None else 0,
                pipeline="async", t0=t_drain)
            t_drain = time.monotonic()

        while state.generation < target:
            if self.faults is not None:
                self.faults.fire("search.generation",
                                 generation=state.generation)
            can_produce = produced < target \
                and len(inflight) <= self.cfg.lookahead
            if next_barrier is not None and produced >= next_barrier:
                can_produce = False  # drain barrier: admit nothing more
            if can_produce:
                t0 = time.monotonic()
                timings: Dict[str, float] = {}
                spawned = self._spawn_children(state,
                                               extra_seen=inflight_hashes)
                timings["children"] = time.monotonic() - t0
                t = time.monotonic()
                accepted, plan, sub, n_children = empty, None, None, 0
                if spawned is not None:
                    children = self._score(spawned[0], spawned[1],
                                           generation=produced + 1)
                    acc_idx = sel.preselect_children(
                        self.rng, state.pop.cheap, children.cheap,
                        self.cfg.n_accept, cols=self._kde_cols)
                    accepted = children.take(acc_idx)
                    n_children = len(children)
                    plan = self._plan_training(state, accepted,
                                               np.arange(len(accepted)))
                    if plan is not None:
                        sub = self._submit_training(
                            plan.genomes,
                            phashes=[str(accepted.phash[i])
                                     for i in plan.todo],
                            admit=admit)
                timings["cheap_score"] = time.monotonic() - t
                inflight_hashes.update(str(h) for h in accepted.phash)
                inflight.append({"accepted": accepted, "plan": plan,
                                 "sub": sub, "n_children": n_children,
                                 "timings": timings})
                produced += 1
                continue
            drain()
            if next_barrier is not None and not inflight \
                    and state.generation >= next_barrier:
                # pipeline fully drained at the barrier: this state is a
                # consistent cut (no lookahead RNG draws beyond it)
                self.save_state(state, ckpt_path)
                saved_gen = state.generation
                next_barrier = state.generation + barrier
        if ckpt_path is not None and state.generation > saved_gen:
            self.save_state(state, ckpt_path)
        return state

    # ------------------------------------------------------- checkpointing
    # The paper's search runs two days on a GPU farm; a preempted search
    # must resume mid-generation.  State is plain JSON (genomes are small
    # int tuples) written atomically.  The search's RNG state rides along so
    # a resumed search is bit-identical to an uninterrupted one.
    def save_state(self, state: NASState, path: str) -> None:
        import json as _json
        import os as _os
        pop = state.pop
        trained = pop.trained_mask
        payload = {
            "generation": state.generation,
            "history": state.history,
            "schema": self.schema.to_json(),
            "evaluated": {k: v.tolist()
                          for k, v in state.evaluated_hashes.items()},
            "rng_state": self.rng.bit_generator.state,
            "population": [{
                "genome": dataclasses.asdict(pop.enc.genome(i)),
                "cheap": pop.cheap[i].tolist(),
                "expensive": pop.expensive[i].tolist()
                if trained[i] else None,
                "phash": str(pop.phash[i]),
                "generation": int(pop.born[i]),
            } for i in range(len(pop))],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(payload, f)
        if _os.path.exists(path):
            # rotate: the previous checkpoint survives as `<path>.prev`, so
            # a write that lands corrupt (torn disk, injected fault) still
            # leaves one loadable generation behind (DESIGN.md §13)
            _os.replace(path, path + ".prev")
        _os.replace(tmp, path)
        if self.faults is not None:
            spec = self.faults.fire("ckpt.save", path=path)
            if spec is not None and spec.kind == "corrupt":
                self.faults.corrupt_file(path)

    def load_state(self, path: str) -> NASState:
        """Restore a checkpoint.  Also restores this search's RNG state (when
        present — older checkpoints load fine without it), so resuming
        reproduces the uninterrupted run bit-for-bit.

        A checkpoint that fails to *parse* (truncated/corrupt JSON — the
        write died mid-flight) falls back to the rotated ``<path>.prev``
        with a warning instead of crashing: losing one generation beats
        losing a days-long search.  When BOTH generations are torn (a
        double fault) the caller gets one clean ``RuntimeError`` naming
        both files and both parse errors — never a raw mid-parse traceback
        from the fallback path.  Configuration errors (schema mismatch)
        still raise — falling back would mask them.

        The persisted objective schema is validated against this search's
        backend: resuming a checkpoint under a different platform set would
        silently misread the cheap matrix, so a mismatch raises.  Pre-schema
        checkpoints are accepted when the column count matches."""
        import json as _json
        import os as _os
        torn = (_json.JSONDecodeError, KeyError, TypeError, IndexError,
                UnicodeDecodeError)
        try:
            return self._load_checkpoint(path)
        except torn as e:
            prev = path + ".prev"
            if not _os.path.exists(prev):
                raise
            self.log(f"[nas] WARNING: checkpoint {path} is corrupt "
                     f"({type(e).__name__}: {e}) — falling back to the "
                     f"rotated previous checkpoint {prev}")
            try:
                return self._load_checkpoint(prev)
            except torn as e2:
                raise RuntimeError(
                    f"both checkpoints are corrupt: {path} "
                    f"({type(e).__name__}: {e}) and {prev} "
                    f"({type(e2).__name__}: {e2}) — no loadable "
                    f"generation survives; restart the search") from e2

    def _load_checkpoint(self, path: str) -> NASState:
        import json as _json
        with open(path) as f:
            payload = _json.load(f)
        if "schema" in payload:
            saved = ObjectiveSchema.from_json(payload["schema"])
            if saved != self.schema:
                raise ValueError(
                    f"checkpoint objective schema "
                    f"{list(saved.qualified_names)} does not match this "
                    f"search's backend schema "
                    f"{list(self.schema.qualified_names)} — resume with the "
                    f"same backends/goal configuration")
        members = payload["population"]
        if members and len(members[0]["cheap"]) != len(self.schema):
            raise ValueError(
                f"checkpoint cheap matrix has {len(members[0]['cheap'])} "
                f"columns; this search's schema has {len(self.schema)}")
        genomes = [Genome(
            op_genes=tuple(m["genome"]["op_genes"]),
            conn_genes=tuple(m["genome"]["conn_genes"]),
            out_gene=m["genome"]["out_gene"],
            w_bits_gene=m["genome"]["w_bits_gene"],
            a_bits_gene=m["genome"]["a_bits_gene"],
            i_bits_gene=m["genome"]["i_bits_gene"],
            dec_gene=m["genome"]["dec_gene"]) for m in members]
        expensive = np.full((len(members), len(self._exp_worst)), np.nan)
        for i, m in enumerate(members):
            if m["expensive"] is not None:
                expensive[i] = m["expensive"]
        pop = PopulationArrays(
            enc=PopulationEncoding.from_genomes(genomes),
            cheap=np.asarray([m["cheap"] for m in members], np.float64),
            expensive=expensive,
            phash=np.asarray([m["phash"] for m in members], dtype=object),
            born=np.asarray([m["generation"] for m in members], np.int64),
            schema=self.schema)
        if "rng_state" in payload:
            self.rng.bit_generator.state = payload["rng_state"]
        return NASState(
            pop=pop, generation=payload["generation"],
            evaluated_hashes={k: np.asarray(v)
                              for k, v in payload["evaluated"].items()},
            history=payload["history"])

    def run_resumable(self, ckpt_path: str,
                      generations: Optional[int] = None) -> NASState:
        """Resume from `ckpt_path` if present; checkpoint as the search
        progresses (DESIGN.md §13).

        The ``off`` and ``host_overlap`` pipelines checkpoint every
        ``ckpt_every`` generations (default 1; their trajectories are
        identical, so a search may even resume under the other mode).  The
        ``async`` pipeline checkpoints at *drain barriers*: every
        ``ckpt_every`` (default ``lookahead + 1``) generations it stops
        admitting lookahead work, drains the in-flight generations, and
        persists the consistent state — so a preempted async search resumes
        from the last barrier instead of being rejected.

        Preemption is graceful: ``KeyboardInterrupt`` (and ``SIGTERM``,
        translated when running in the main thread) persists the last
        consistent state before re-raising, so the next invocation resumes
        exactly where this one stopped — bit-identically for the
        deterministic pipelines."""
        import os as _os
        import signal as _signal
        target = generations or self.cfg.generations
        if _os.path.exists(ckpt_path):
            state = self.load_state(ckpt_path)
            self.log(f"[nas] resumed at generation {state.generation}")
        else:
            state = self.init_state()
            # persist immediately: a preemption before the first checkpoint
            # must not lose the (expensive) initial population training
            self.save_state(state, ckpt_path)
        saved_gen = state.generation

        def _on_sigterm(signum, frame):
            raise KeyboardInterrupt("SIGTERM")

        installed, old_handler = False, None
        try:
            old_handler = _signal.signal(_signal.SIGTERM, _on_sigterm)
            installed = True
        except ValueError:
            pass  # not the main thread: SIGTERM stays with the host app
        try:
            if self.cfg.pipeline == "async":
                if state.generation < target:
                    state = self._run_async(target - state.generation,
                                            state=state,
                                            ckpt_path=ckpt_path)
                saved_gen = state.generation
            else:
                every = self.cfg.ckpt_every or 1
                while state.generation < target:
                    if self.faults is not None:
                        self.faults.fire("search.generation",
                                         generation=state.generation)
                    state = self.step(state)
                    if state.generation - saved_gen >= every \
                            or state.generation >= target:
                        self.save_state(state, ckpt_path)
                        saved_gen = state.generation
        except KeyboardInterrupt:
            # graceful preemption: the state object always sits at the last
            # *completed* generation (selection publishes atomically), so
            # persist it if the disk is behind, then let the signal
            # propagate to the host
            if state.generation > saved_gen:
                self.save_state(state, ckpt_path)
            self.log(f"[nas] preempted at generation {state.generation}; "
                     f"checkpoint {ckpt_path} holds a consistent resume "
                     f"point")
            raise
        finally:
            if installed:
                _signal.signal(_signal.SIGTERM,
                               old_handler if old_handler is not None
                               else _signal.SIG_DFL)
        return state

    # ---------------------------------------------------------------- report
    def select_solution(self, state: NASState,
                        objective: str = "energy_max_alpha_j",
                        platform: Optional[str] = None
                        ) -> Optional[Candidate]:
        """Best feasible candidate for a deployment objective (paper §VI-B).

        ``objective`` is a schema query, not a position: pass a bare name
        (single-platform searches), a qualified ``platform:name``, or a bare
        name plus ``platform`` to disambiguate a multi-platform schema.
        """
        idx = self.schema.index(objective, platform=platform)
        feas = state.pop.feasible_mask(self.constraints)
        if not feas.any():
            return None
        rows = np.nonzero(feas)[0]
        return state.pop.candidate(
            int(rows[np.argmin(state.pop.cheap[rows, idx])]))

    def select_for_goal(self, state: NASState,
                        goal: Union[None, str, DesignGoal] = None
                        ) -> Optional[Candidate]:
        """Best feasible candidate under a design goal (default: the
        search's own).  With several platforms in the goal's scope the
        ranking value is the *worst* (max) primary objective across them —
        the robust cross-platform pick."""
        g = self.goal if goal is None else get_goal(goal)
        cols = g.primary_indices(self.schema)
        feas = state.pop.feasible_mask(
            g.effective_constraints(self.cfg.constraints))
        if not feas.any():
            return None
        rows = np.nonzero(feas)[0]
        score = state.pop.cheap[np.ix_(rows, cols)].max(axis=1)
        return state.pop.candidate(int(rows[np.argmin(score)]))

    def pareto_fronts(self, state: NASState) -> Dict[str, np.ndarray]:
        """Per-platform and cross-platform Pareto fronts of the population.

        Returns ``{"cross_platform": idx, <platform>: idx, ...}`` — front
        membership over the full objective matrix and over each platform's
        column group (its cheap columns + the expensive pair).  All fronts
        come from one shared pass over the per-column comparisons
        (:func:`~repro_torch.core.pareto.domination_matrices`).
        """
        objs = state.pop.objective_matrix()
        n_cols = len(self.full_schema)
        # single-platform schemas: every platform group equals the full
        # column set — alias the cross-platform front instead of building
        # identical (N, N) matrices
        groups = {"cross_platform": np.arange(n_cols)}
        for p in self.schema.platforms:
            cols = self.full_schema.platform_group(p)
            if len(cols) < n_cols:
                groups[p] = cols
        doms = domination_matrices(objs, list(groups.values()))
        fronts = {name: np.nonzero(dom.sum(axis=0) == 0)[0]
                  for name, dom in zip(groups, doms)}
        for p in self.schema.platforms:
            fronts.setdefault(p, fronts["cross_platform"])
        return fronts
