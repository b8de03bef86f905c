"""Genetic encoding with dormant genes (paper §III-A, via Suganuma et al. '17).

A copy of ``repro/core/genome.py`` (numpy only), imports repointed to the
port.  Its batch operators serve the search loop (``core/evolution.py``).

Cartesian-genetic-programming-style linear encoding: the genome holds
``max_depth`` node slots; each node has a *function gene* (index into the op
table) and a *connection gene* (which earlier node, or the input, feeds it).
The phenotype is decoded by walking back from the *output gene* — nodes not
on that path are **dormant**: they are carried (and mutated) silently and can
be re-activated by a later connection-gene mutation.  This is the paper's
"concept of dormant genes" that boosts the evolutionary search.

Additional genes: quantization (weights / activations / input) and input
decimation, reflecting the paper's hardware-aware search space.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.hwlib.layers import LayerSpec, OpCostTable, out_shape
from repro_torch.hwlib.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class Genome:
    """Immutable genome. All gene values are small ints (numpy-friendly)."""

    op_genes: Tuple[int, ...]      # len == max_depth, values in [0, n_ops)
    conn_genes: Tuple[int, ...]    # node i takes input from conn[i] in [0, i]
    out_gene: int                  # node (1-indexed) feeding the head
    w_bits_gene: int
    a_bits_gene: int
    i_bits_gene: int
    dec_gene: int                  # input decimation index

    # ---------------------------------------------------------------- decode
    def active_nodes(self) -> List[int]:
        """Indices (0-based) of nodes on the input→output path, in order."""
        path: List[int] = []
        node = self.out_gene  # 1-indexed; 0 means "the input" (invalid here)
        while node > 0:
            path.append(node - 1)
            node = self.conn_genes[node - 1]
        return list(reversed(path))

    def phenotype(self, space: SearchSpace = DEFAULT_SPACE) -> List[LayerSpec]:
        """The decoded topology: active ops + the fixed GAP/dense head."""
        specs = [space.ops[self.op_genes[i]] for i in self.active_nodes()]
        specs.extend(space.head_specs())
        return specs

    def depth(self) -> int:
        """Searchable depth (final GAP+dense excluded, as in the paper)."""
        return len(self.active_nodes())

    def quant(self, space: SearchSpace = DEFAULT_SPACE) -> QuantConfig:
        return space.quant_config(self.w_bits_gene, self.a_bits_gene,
                                  self.i_bits_gene)

    def input_length(self, space: SearchSpace = DEFAULT_SPACE) -> int:
        return space.input_length(self.dec_gene)

    def phenotype_hash(self, space: SearchSpace = DEFAULT_SPACE) -> str:
        """Hash of the *expressed* genes only — mutations that touch dormant
        genes leave this unchanged, letting the search skip re-evaluation
        (the dormant-gene shortcut)."""
        parts = [s.short() for s in self.phenotype(space)]
        parts.append(self.quant(space).short())
        parts.append(f"dec{self.dec_gene}")
        return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]

    def is_valid(self, space: SearchSpace = DEFAULT_SPACE) -> bool:
        """Depth bounds + every layer's spatial shape stays >= 1."""
        d = self.depth()
        if not (space.min_depth <= d <= space.max_depth):
            return False
        try:
            shapes = decode_shapes(self, space)
        except ValueError:
            return False
        return all(l >= 1 for l, _ in shapes)


def decode_shapes(g: Genome, space: SearchSpace = DEFAULT_SPACE
                  ) -> List[Tuple[int, int]]:
    """(length, channels) after each phenotype layer."""
    l, c = g.input_length(space), 2
    shapes = []
    for spec in g.phenotype(space):
        l, c = out_shape(spec, l, c)
        shapes.append((l, c))
    return shapes


# ---------------------------------------------------------------------------
# Batched population encoding
# ---------------------------------------------------------------------------

# Sentinel op ids for the fixed head appended to every phenotype.  The op
# table proper occupies ids [0, n_ops); the head layers get the next two ids
# so a whole phenotype is a single integer array (see OpCostTable.for_space).
GAP_OP_OFFSET = 0    # id == space.n_ops
DENSE_OP_OFFSET = 1  # id == space.n_ops + 1


@dataclasses.dataclass(frozen=True)
class PopulationEncoding:
    """A whole population as stacked integer gene arrays.

    Column-for-column the same genes as :class:`Genome`, but shaped ``(N, D)``
    /``(N,)`` so the population can be decoded and costed with vectorized
    numpy instead of per-genome Python loops (DESIGN.md §2).  The encoding is
    immutable; arrays must not be written through.
    """

    op: np.ndarray       # (N, D) int64 — function genes
    conn: np.ndarray     # (N, D) int64 — connection genes
    out: np.ndarray      # (N,)  int64 — output genes (1-indexed)
    w_bits: np.ndarray   # (N,)  int64
    a_bits: np.ndarray   # (N,)  int64
    i_bits: np.ndarray   # (N,)  int64
    dec: np.ndarray      # (N,)  int64

    def __len__(self) -> int:
        return self.op.shape[0]

    @property
    def max_depth(self) -> int:
        return self.op.shape[1]

    @classmethod
    def from_genomes(cls, genomes: Sequence[Genome]) -> "PopulationEncoding":
        if not genomes:
            raise ValueError("empty population")
        return cls(
            op=np.asarray([g.op_genes for g in genomes], dtype=np.int64),
            conn=np.asarray([g.conn_genes for g in genomes], dtype=np.int64),
            out=np.asarray([g.out_gene for g in genomes], dtype=np.int64),
            w_bits=np.asarray([g.w_bits_gene for g in genomes], dtype=np.int64),
            a_bits=np.asarray([g.a_bits_gene for g in genomes], dtype=np.int64),
            i_bits=np.asarray([g.i_bits_gene for g in genomes], dtype=np.int64),
            dec=np.asarray([g.dec_gene for g in genomes], dtype=np.int64),
        )

    def take(self, idx) -> "PopulationEncoding":
        """Row-gather a sub-population (fancy index or boolean mask)."""
        idx = np.asarray(idx)
        return PopulationEncoding(
            op=self.op[idx], conn=self.conn[idx], out=self.out[idx],
            w_bits=self.w_bits[idx], a_bits=self.a_bits[idx],
            i_bits=self.i_bits[idx], dec=self.dec[idx])

    @classmethod
    def concatenate(cls, parts: Sequence["PopulationEncoding"]
                    ) -> "PopulationEncoding":
        parts = [p for p in parts if len(p)]
        if not parts:
            raise ValueError("empty concatenation")
        if len(parts) == 1:
            return parts[0]
        return cls(*(np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)))

    def genome(self, i: int) -> Genome:
        return Genome(
            op_genes=tuple(int(v) for v in self.op[i]),
            conn_genes=tuple(int(v) for v in self.conn[i]),
            out_gene=int(self.out[i]),
            w_bits_gene=int(self.w_bits[i]),
            a_bits_gene=int(self.a_bits[i]),
            i_bits_gene=int(self.i_bits[i]),
            dec_gene=int(self.dec[i]),
        )

    def to_genomes(self) -> List[Genome]:
        return [self.genome(i) for i in range(len(self))]

    # ------------------------------------------------------------ decoding
    def decode_paths(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized active-path walk for the whole population.

        Returns ``(path, depth)``: ``path`` is ``(N, D)`` with the 0-based
        active node indices in forward (input→output) order, ``-1``-padded;
        ``depth`` is ``(N,)``.  Connection genes satisfy ``conn[i] <= i`` so
        the backward walk terminates within ``D`` steps for every genome.
        """
        n, d = self.op.shape
        ar = np.arange(n)
        rev = np.full((n, d), -1, dtype=np.int64)
        node = self.out.copy()  # 1-indexed; 0 means "the input"
        for t in range(d):
            alive = node > 0
            idx = np.where(alive, node - 1, 0)
            rev[:, t] = np.where(alive, idx, -1)
            node = np.where(alive, self.conn[ar, idx], 0)
        depth = (rev >= 0).sum(axis=1)
        # reverse each row's valid prefix to get forward order
        src = depth[:, None] - 1 - np.arange(d)[None, :]
        fwd = np.take_along_axis(rev, np.maximum(src, 0), axis=1)
        return np.where(src >= 0, fwd, -1), depth

    def phenotype_ops(self, space: SearchSpace = DEFAULT_SPACE
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded phenotype op-id arrays for the whole population.

        Returns ``(ops, valid, depth)``: ``ops`` is ``(N, D+2)`` — the active
        ops in forward order followed by the GAP and DENSE head sentinels
        (ids ``n_ops`` and ``n_ops + 1``), ``-1``-padded; ``valid`` is the
        matching boolean mask.
        """
        path, depth = self.decode_paths()
        n, d = self.op.shape
        ops = np.full((n, d + 2), -1, dtype=np.int64)
        gathered = np.take_along_axis(self.op, np.maximum(path, 0), axis=1)
        ops[:, :d] = np.where(path >= 0, gathered, -1)
        ar = np.arange(n)
        ops[ar, depth] = space.n_ops + GAP_OP_OFFSET
        ops[ar, depth + 1] = space.n_ops + DENSE_OP_OFFSET
        return ops, ops >= 0, depth

    def input_lengths(self, space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
        table = np.asarray([space.input_length(i)
                            for i in range(len(space.input_decimations))],
                           dtype=np.int64)
        return table[self.dec]

    def batch_phenotype_hash(self, space: SearchSpace = DEFAULT_SPACE
                             ) -> List[str]:
        """Per-genome expressed-gene hashes, identical to
        :meth:`Genome.phenotype_hash` (the dormant-gene dedup key)."""
        ops, _, _ = self.phenotype_ops(space)
        shorts = [s.short() for s in space.ops]
        shorts += [s.short() for s in space.head_specs()]
        hashes = []
        for i in range(len(self)):
            parts = [shorts[o] for o in ops[i] if o >= 0]
            parts.append(space.quant_config(int(self.w_bits[i]),
                                            int(self.a_bits[i]),
                                            int(self.i_bits[i])).short())
            parts.append(f"dec{int(self.dec[i])}")
            hashes.append(hashlib.sha1(
                "|".join(parts).encode()).hexdigest()[:16])
        return hashes


# ---------------------------------------------------------------------------
# Random construction / mutation / crossover
# ---------------------------------------------------------------------------

def random_genome(rng: np.random.Generator,
                  space: SearchSpace = DEFAULT_SPACE,
                  max_tries: int = 200) -> Genome:
    for _ in range(max_tries):
        n = space.max_depth
        op = tuple(int(v) for v in rng.integers(0, space.n_ops, n))
        # chain-biased connections: mostly the previous node, sometimes a skip
        conn = []
        for i in range(n):
            conn.append(int(rng.integers(0, i + 1)) if rng.random() < 0.25
                        else i)
        g = Genome(
            op_genes=op,
            conn_genes=tuple(conn),
            out_gene=int(rng.integers(space.min_depth, n + 1)),
            w_bits_gene=int(rng.integers(0, len(space.weight_bits))),
            a_bits_gene=int(rng.integers(0, len(space.act_bits))),
            i_bits_gene=int(rng.integers(0, len(space.input_bits))),
            dec_gene=int(rng.integers(0, len(space.input_decimations))),
        )
        if g.is_valid(space):
            return g
    raise RuntimeError("could not sample a valid genome")


def mutate(
    g: Genome,
    rng: np.random.Generator,
    space: SearchSpace = DEFAULT_SPACE,
    rate: float = 0.1,
    force_active_change: bool = True,
    max_tries: int = 200,
) -> Genome:
    """Point mutation. With ``force_active_change`` the mutation loop repeats
    until the *phenotype* changes (Suganuma's forced mutation for children);
    without it, a mutation may hit only dormant genes (neutral drift)."""
    base_hash = g.phenotype_hash(space)
    for _ in range(max_tries):
        op = list(g.op_genes)
        conn = list(g.conn_genes)
        out = g.out_gene
        wq, aq, iq, dq = (g.w_bits_gene, g.a_bits_gene, g.i_bits_gene,
                          g.dec_gene)
        for i in range(len(op)):
            if rng.random() < rate:
                op[i] = int(rng.integers(0, space.n_ops))
            if rng.random() < rate:
                conn[i] = int(rng.integers(0, i + 1))
        if rng.random() < rate:
            out = int(rng.integers(1, len(op) + 1))
        if rng.random() < rate:
            wq = int(rng.integers(0, len(space.weight_bits)))
        if rng.random() < rate:
            aq = int(rng.integers(0, len(space.act_bits)))
        if rng.random() < rate:
            iq = int(rng.integers(0, len(space.input_bits)))
        if rng.random() < rate:
            dq = int(rng.integers(0, len(space.input_decimations)))
        cand = Genome(tuple(op), tuple(conn), out, wq, aq, iq, dq)
        if not cand.is_valid(space):
            continue
        if force_active_change and cand.phenotype_hash(space) == base_hash:
            continue  # mutation was neutral (dormant genes only) — retry
        return cand
    return g  # give up: return parent unchanged


def crossover(a: Genome, b: Genome, rng: np.random.Generator,
              space: SearchSpace = DEFAULT_SPACE,
              max_tries: int = 50) -> Genome:
    """Single-point crossover over the node slots (biology-inspired ops the
    genetic encoding enables, paper §II-A)."""
    n = len(a.op_genes)
    for _ in range(max_tries):
        cut = int(rng.integers(1, n))
        op = a.op_genes[:cut] + b.op_genes[cut:]
        conn = a.conn_genes[:cut] + b.conn_genes[cut:]
        donor = a if rng.random() < 0.5 else b
        cand = Genome(op, conn, donor.out_gene, donor.w_bits_gene,
                      donor.a_bits_gene, donor.i_bits_gene, donor.dec_gene)
        if cand.is_valid(space):
            return cand
    return a


# ---------------------------------------------------------------------------
# Vectorized genetic operators (DESIGN.md §8)
#
# Batch counterparts of random_genome / mutate / crossover / is_valid over a
# whole PopulationEncoding.  Each is a rejection sampler drawing candidate
# gene arrays from exactly the same per-genome proposal distribution as its
# scalar reference (the RNG is consumed in a different order, so streams
# differ, but the output *distributions* match — tested under fixed seeds in
# tests/test_genome_batch_ops.py).  Genomes still unresolved after max_tries
# rounds fall back to their input row, like the scalar operators.
# ---------------------------------------------------------------------------

_COST_TABLE_CACHE: dict = {}


def _cost_table(space: SearchSpace) -> OpCostTable:
    """Op catalogue + head sentinels as an OpCostTable, cached per space."""
    table = _COST_TABLE_CACHE.get(space)
    if table is None:
        table = OpCostTable.from_specs(tuple(space.ops) + space.head_specs())
        _COST_TABLE_CACHE[space] = table
    return table


def is_valid_batch(enc: PopulationEncoding,
                   space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
    """Vectorized :meth:`Genome.is_valid`: ``(N,)`` bool.

    Depth bounds plus the batched shape decode: a genome is valid iff every
    phenotype layer's input window fits (``in_len >= kernel`` for convs,
    ``in_len >= stride`` for pools — the conditions under which the scalar
    ``out_shape`` raises), which also guarantees every spatial shape >= 1.
    """
    ops, valid, depth = enc.phenotype_ops(space)
    ok = (depth >= space.min_depth) & (depth <= space.max_depth)
    table = _cost_table(space)
    safe = np.maximum(ops, 0)
    ek = table.ek_const[safe]
    ekl = table.ek_is_len[safe]
    es = table.es[safe]
    # only the length trajectory matters: validity never depends on channels
    length = enc.input_lengths(space)
    for t in range(ops.shape[1]):
        window = ek[:, t] + ekl[:, t] * length
        v = valid[:, t]
        ok &= ~v | (length >= window)
        length = np.where(v, (length - window) // es[:, t] + 1, length)
    return ok


def random_population(rng: np.random.Generator, n: int,
                      space: SearchSpace = DEFAULT_SPACE,
                      max_tries: int = 200) -> PopulationEncoding:
    """Vectorized :func:`random_genome`: ``n`` valid genomes in a handful of
    array draws (same chain-biased connection prior, same rejection rule)."""
    d = space.max_depth
    conn_hi = np.arange(1, d + 1)
    chain = np.arange(d)
    parts: List[PopulationEncoding] = []
    got = 0
    for _ in range(max_tries):
        need = n - got
        if need <= 0:
            break
        cand = PopulationEncoding(
            op=rng.integers(0, space.n_ops, (need, d)),
            conn=np.where(rng.random((need, d)) < 0.25,
                          rng.integers(0, conn_hi, (need, d)),
                          chain[None, :]),
            out=rng.integers(space.min_depth, d + 1, need),
            w_bits=rng.integers(0, len(space.weight_bits), need),
            a_bits=rng.integers(0, len(space.act_bits), need),
            i_bits=rng.integers(0, len(space.input_bits), need),
            dec=rng.integers(0, len(space.input_decimations), need),
        )
        ok = is_valid_batch(cand, space)
        if ok.any():
            parts.append(cand.take(np.nonzero(ok)[0]))
            got += int(ok.sum())
    if got < n:
        raise RuntimeError("could not sample a valid population")
    return PopulationEncoding.concatenate(parts).take(np.arange(n))


def mutate_batch(
    enc: PopulationEncoding,
    rng: np.random.Generator,
    space: SearchSpace = DEFAULT_SPACE,
    rate: float = 0.1,
    force_active_change: bool = True,
    max_tries: int = 200,
) -> PopulationEncoding:
    """Vectorized :func:`mutate` over a whole population.

    Every genome independently redraws (from its own parent, like the scalar
    retry loop) until the draw is valid — and, with ``force_active_change``,
    until its phenotype hash differs from the parent's (Suganuma's forced
    mutation).  Rows unresolved after ``max_tries`` rounds stay the parent.
    """
    n, d = enc.op.shape
    base_hash = np.asarray(enc.batch_phenotype_hash(space), dtype=object) \
        if force_active_change else None
    out_enc = {f.name: getattr(enc, f.name).copy()
               for f in dataclasses.fields(PopulationEncoding)}
    conn_hi = np.arange(1, d + 1)
    pending = np.arange(n)
    for _ in range(max_tries):
        if not len(pending):
            break
        m = len(pending)
        op = enc.op[pending].copy()
        conn = enc.conn[pending].copy()
        mask = rng.random((m, d)) < rate
        op[mask] = rng.integers(0, space.n_ops, int(mask.sum()))
        conn = np.where(rng.random((m, d)) < rate,
                        rng.integers(0, conn_hi, (m, d)), conn)
        cand = PopulationEncoding(
            op=op, conn=conn,
            out=np.where(rng.random(m) < rate,
                         rng.integers(1, d + 1, m), enc.out[pending]),
            w_bits=np.where(rng.random(m) < rate,
                            rng.integers(0, len(space.weight_bits), m),
                            enc.w_bits[pending]),
            a_bits=np.where(rng.random(m) < rate,
                            rng.integers(0, len(space.act_bits), m),
                            enc.a_bits[pending]),
            i_bits=np.where(rng.random(m) < rate,
                            rng.integers(0, len(space.input_bits), m),
                            enc.i_bits[pending]),
            dec=np.where(rng.random(m) < rate,
                         rng.integers(0, len(space.input_decimations), m),
                         enc.dec[pending]),
        )
        ok = is_valid_batch(cand, space)
        if force_active_change and ok.any():
            ok_rows = np.nonzero(ok)[0]
            new_hash = np.asarray(
                cand.take(ok_rows).batch_phenotype_hash(space), dtype=object)
            ok[ok_rows] = new_hash != base_hash[pending[ok_rows]]
        acc = pending[ok]
        for name in out_enc:
            out_enc[name][acc] = getattr(cand, name)[ok]
        pending = pending[~ok]
    return PopulationEncoding(**out_enc)


def crossover_batch(a: PopulationEncoding, b: PopulationEncoding,
                    rng: np.random.Generator,
                    space: SearchSpace = DEFAULT_SPACE,
                    max_tries: int = 50) -> PopulationEncoding:
    """Vectorized :func:`crossover` of row-aligned parent populations:
    per-row single-point cut over the node slots, quant/output genes from a
    fair-coin donor, rejection until valid (fallback: parent ``a``)."""
    n, d = a.op.shape
    out_enc = {f.name: getattr(a, f.name).copy()
               for f in dataclasses.fields(PopulationEncoding)}
    pending = np.arange(n)
    for _ in range(max_tries):
        if not len(pending):
            break
        m = len(pending)
        keep_a = np.arange(d)[None, :] < rng.integers(1, d, m)[:, None]
        donor_b = rng.random(m) >= 0.5

        def pick(name, mask=donor_b):
            av, bv = getattr(a, name)[pending], getattr(b, name)[pending]
            return np.where(mask, bv, av)

        cand = PopulationEncoding(
            op=pick("op", ~keep_a), conn=pick("conn", ~keep_a),
            out=pick("out"), w_bits=pick("w_bits"), a_bits=pick("a_bits"),
            i_bits=pick("i_bits"), dec=pick("dec"))
        ok = is_valid_batch(cand, space)
        acc = pending[ok]
        for name in out_enc:
            out_enc[name][acc] = getattr(cand, name)[ok]
        pending = pending[~ok]
    return PopulationEncoding(**out_enc)


def describe(g: Genome, space: SearchSpace = DEFAULT_SPACE) -> str:
    """Fig.-4-style textual rendering of a genome's phenotype."""
    lines = [f"Input ({g.input_length(space)},2)  quant={g.quant(space).short()}"]
    l, c = g.input_length(space), 2
    from repro_torch.hwlib.layers import layer_cost
    for spec in g.phenotype(space):
        cost = layer_cost(spec, l, c)
        l, c = cost.out_len, cost.out_channels
        lines.append(f"  {spec.short():>12s} [{cost.params}] ({l},{c})")
    return "\n".join(lines)
