"""Port paged decode attention vs the reference (CPU): the op's plain path
against the reference's Pallas kernel (interpret mode, as its own tests
run it off-TPU) and its oracle, the paged-equals-dense contract, the block
allocator, and one paged decode step of the whole model.

The port's CUDA kernel needs the card; its on-card checks are in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    paged_decode_attention as jax_paged_op,
)
from repro.kernels.decode_attention.ref import (
    gather_paged_kv as jax_gather,
)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_ref,
)
from repro.models.transformer import init_paged_cache as jax_init_paged
from repro.models.transformer import lm_decode_step_paged as jax_decode_paged
from repro.serve.paged import BlockPool as JaxBlockPool
from repro.serve.paged import blocks_for as jax_blocks_for
from repro_torch.kernels.decode_attention import (
    decode_attention_ref,
    gather_paged_kv,
    paged_decode_attention,
    paged_decode_attention_ref,
)
from repro_torch.models.attention import (
    paged_pool,
    paged_write_index,
    pool_with_spare,
)
from repro_torch.models.transformer import (
    init_paged_cache,
    lm_decode_step_paged,
)
from repro_torch.serve.paged import BlockPool, blocks_for
from torch_parity import F32_TOL, configs, np_of, params


def _paged_case(b, nb, bs, kvh, rep, hd, lens, seed=0, spare=3):
    """Shuffled pool pages shared out across rows, sentinel (= P) entries
    past each row's kv_len, pages the tables never touch."""
    rng = np.random.default_rng(seed)
    p = b * nb + spare
    q = rng.normal(size=(b, kvh * rep, hd)).astype(np.float32)
    kp = rng.normal(size=(p, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(p, bs, kvh, hd)).astype(np.float32)
    perm = rng.permutation(p)[:b * nb].reshape(b, nb)
    tables = np.full((b, nb), p, np.int32)
    for row, n in enumerate(lens):
        used = min(-(-int(n) // bs), nb)
        tables[row, :used] = perm[row, :used]
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_version_matches_reference_kernel_and_oracle(bs, rep, hd):
    """kv_len of 1, the full span, and lengths that end mid-page."""
    nb = 5
    lens = [1, nb * bs, bs + 1, 2 * bs + bs // 2]
    case = _paged_case(4, nb, bs, 2, rep, hd, lens)
    got = paged_decode_attention(*map(torch.from_numpy, case))
    args = tuple(map(jnp.asarray, case))
    np.testing.assert_allclose(np_of(got), np.asarray(jax_paged_ref(*args)),
                               **F32_TOL)
    np.testing.assert_allclose(
        np_of(got), np.asarray(jax_paged_op(*args, impl="pallas",
                                            interpret=True)), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep,kvh", [(12, 2), (48, 1)],
                         ids=["rep12", "rep48"])
def test_wide_gqa_groups_match_reference_kernel(rep, kvh, dtype):
    """GQA ratios past 8 (mistral-large-123b's 12, granite-34b's 48 over
    one KV head) at hd 128 over a shuffled pool: the port's wrapper on the
    CPU against the reference's Pallas kernel in interpret mode; f32 to
    F32_TOL, bf16 to one bf16 rounding of the output (2e-2)."""
    import ml_dtypes
    nb, bs = 4, 8
    case = list(_paged_case(3, nb, bs, kvh, rep, 128, [1, nb * bs, bs + 3]))
    if dtype == "bfloat16":
        case[:3] = [a.astype(ml_dtypes.bfloat16) for a in case[:3]]
    got = paged_decode_attention(
        *(torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in case[:3]), *map(torch.from_numpy, case[3:]))
    want = jax_paged_op(*map(jnp.asarray, case), impl="pallas",
                        interpret=True)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    assert got.shape == (3, kvh * rep, 128)
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want).astype(np.float32), **tol)


def test_kv_len_past_the_span_reads_the_whole_table():
    """A finished slot at the cache boundary has kv_len = NB*BS + 1: the
    row attends to its NB*BS positions, as the reference does."""
    nb, bs = 3, 4
    q, kp, vp, tables, _ = _paged_case(2, nb, bs, 1, 2, 32, [nb * bs] * 2)
    over = np.asarray([nb * bs + 1, nb * bs + 9], np.int32)
    got = paged_decode_attention(*map(torch.from_numpy,
                                      (q, kp, vp, tables, over)))
    want = jax_paged_ref(*map(jnp.asarray, (q, kp, vp, tables, over)))
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)
    full = paged_decode_attention(*map(torch.from_numpy, (
        q, kp, vp, tables, np.full(2, nb * bs, np.int32))))
    assert torch.equal(got, full)


def test_gather_matches_reference():
    q, kp, vp, tables, _ = _paged_case(3, 4, 4, 2, 1, 32, [5, 16, 1])
    got = gather_paged_kv(torch.from_numpy(kp), torch.from_numpy(vp),
                          torch.from_numpy(tables))
    want = jax_gather(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables))
    for g, w in zip(got, want):
        assert np.array_equal(np_of(g), np.asarray(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_equals_dense_on_identity_tables(dtype):
    """NB*BS == S and tables[b] = b*NB + arange(NB): the paged plain
    version is the dense plain version on the same numbers, bit for bit."""
    rng = np.random.default_rng(3)
    b, s, kvh, rep, hd, bs = 3, 32, 2, 4, 64, 8
    nb = s // bs
    q = torch.from_numpy(rng.normal(size=(b, kvh * rep, hd))).to(dtype)
    k = torch.from_numpy(rng.normal(size=(b, s, kvh, hd))).to(dtype)
    v = torch.from_numpy(rng.normal(size=(b, s, kvh, hd))).to(dtype)
    kv_len = torch.tensor([1, s, 13], dtype=torch.int32)
    tables = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    got = paged_decode_attention(q, k.reshape(b * nb, bs, kvh, hd),
                                 v.reshape(b * nb, bs, kvh, hd), tables,
                                 kv_len)
    assert torch.equal(got, decode_attention_ref(q, k, v, kv_len))


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    case = tuple(map(torch.from_numpy,
                     _paged_case(2, 3, 4, 2, 2, 32, [3, 12])))
    before = paged_decode_attention.launches
    out = paged_decode_attention(*case)
    assert torch.equal(out, paged_decode_attention_ref(*case))
    assert paged_decode_attention.launches == before


BAD_TABLES = {
    "int64": lambda t: t.long(),
    "rows_differ": lambda t: t[:1],
    "one_dim": lambda t: t.reshape(-1),
    "not_contiguous": lambda t: torch.cat([t, t], 1)[:, ::2],
    "too_many_blocks": lambda t: torch.zeros((2, 4096), dtype=torch.int32),
}


@pytest.mark.parametrize("case", list(BAD_TABLES))
def test_wrapper_rejects_tables_the_kernel_does_not_take(case):
    q, kp, vp, tables, lens = map(torch.from_numpy,
                                  _paged_case(2, 3, 4, 2, 2, 32, [3, 12]))
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, BAD_TABLES[case](tables), lens)


def test_wrapper_rejects_pools_of_another_dtype():
    q, kp, vp, tables, lens = map(torch.from_numpy,
                                  _paged_case(2, 3, 4, 2, 2, 32, [3, 12]))
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp.to(torch.bfloat16), vp, tables, lens)


# ---------------------------------------------------------------- BlockPool
def _pool_ops(seed, n_ops=200):
    """A seeded sequence of alloc / ensure / free calls."""
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        op = rng.choice(["alloc", "ensure", "free"], p=[0.4, 0.4, 0.2])
        slot = int(rng.integers(0, 4))
        yield op, slot, int(rng.integers(1, 4)), int(rng.integers(0, 40))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_matches_reference(seed):
    ours, ref = BlockPool(20, 8, 4, 5), JaxBlockPool(20, 8, 4, 5)
    for op, slot, n, pos in _pool_ops(seed):
        if op == "alloc":
            assert ours.alloc(slot, n) == ref.alloc(slot, n)
        elif op == "ensure":
            assert ours.ensure(slot, pos) == ref.ensure(slot, pos)
        else:
            assert ours.free_slot(slot) == ref.free_slot(slot)
        assert np.array_equal(ours.table_array(), ref.table_array())
    assert (ours.peak_used, ours.allocs, ours.frees, ours.free_count) == \
        (ref.peak_used, ref.allocs, ref.frees, ref.free_count)


def test_blocks_for_matches_reference():
    for n in range(0, 40):
        for bs in (1, 4, 8, 16):
            assert blocks_for(n, bs) == jax_blocks_for(n, bs)


# ------------------------------------------------ one paged decode step
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b"])
def test_lm_decode_step_paged_matches_reference(arch):
    """Same weights, pools and tables on both sides: shuffled blocks, an
    inactive row (writes nothing), a row at the span's end (kv_len past
    NB*BS: the write clamps to the last position)."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    slots, cache_len, bs, n_blocks = 4, 32, 8, 18
    nb = cache_len // bs
    rng = np.random.default_rng(7)
    cache = jax_init_paged(jcfg, slots, cache_len, n_blocks, bs)
    shape = cache["k"].shape
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    lens = np.asarray([5, 17, cache_len, 9], np.int32)
    active = np.asarray([True, True, True, False])
    perm = rng.permutation(n_blocks)
    tables = np.full((slots, nb), n_blocks, np.int32)
    for s, n in enumerate(lens):
        used = min(n // bs + 1, nb)
        tables[s, :used] = perm[s * nb: s * nb + used]
    tokens = rng.integers(0, jcfg.vocab_size, (slots, 1)).astype(np.int32)

    jl, jc = jax_decode_paged(
        jp, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
             "lens": jnp.asarray(lens), "tables": jnp.asarray(tables)},
        jnp.asarray(tokens), jnp.asarray(active), jcfg)
    tc = init_paged_cache(tcfg, slots, cache_len, n_blocks, bs,
                          device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in cache.items()}
    tc["k"].copy_(torch.from_numpy(k0))
    tc["v"].copy_(torch.from_numpy(v0))
    tc["lens"].copy_(torch.from_numpy(lens))
    tc["tables"].copy_(torch.from_numpy(tables))
    tl, tc = lm_decode_step_paged(tp, tc, torch.from_numpy(tokens),
                                  torch.from_numpy(active), tcfg)
    np.testing.assert_allclose(np_of(tl)[active], np.asarray(jl)[active],
                               **F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np_of(tc[key]), np.asarray(jc[key]),
                                   **F32_TOL)
    assert np.array_equal(np_of(tc["lens"]), np.asarray(jc["lens"]))
    # the inactive row's blocks and every unowned block are untouched
    untouched = np.setdiff1d(np.arange(n_blocks), tables[:3][tables[:3]
                                                             < n_blocks])
    assert np.array_equal(np_of(tc["k"])[:, untouched], k0[:, untouched])


def test_write_index_drops_inactive_rows_and_sentinel_blocks():
    """What the reference's ``mode="drop"`` drops is selected away:
    inactive rows, and active rows whose write block is the sentinel; a
    row past the span writes its last position."""
    n_blocks, bs = 10, 4
    tables = torch.tensor([[3, 7, 10], [1, 10, 10], [0, 2, 5], [4, 6, 8]],
                          dtype=torch.int32)
    lens = torch.tensor([5, 4, 40, 2], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    rows, blk, off = paged_write_index(lens, tables, active, bs, n_blocks)
    assert rows.tolist() == [0, 2]          # row 1 hits a sentinel block
    assert blk.tolist() == [7, 5] and off.tolist() == [1, 3]


@pytest.mark.parametrize("seed", range(6))
def test_write_index_with_spare_blocks_writes_what_nonzero_selects(seed):
    """The fixed-shape write (every row writes, the masked ones to their
    own spare positions) leaves the pool as the ``nonzero`` selection's
    write does, bit for bit: random lengths (some past the span, which
    clamp to its last position), tables with sentinels, inactive rows.
    No masked row reaches a block of the pool, and no two rows write one
    position."""
    rng = np.random.default_rng(seed)
    slots, nb, bs, n_blocks = 7, 4, 4, 18
    tables = np.full((slots, nb), n_blocks, np.int32)
    perm = rng.permutation(n_blocks)
    for s in range(4):                 # slots 4-6 hold no block at all
        n = rng.integers(1, nb + 1)
        tables[s, :n] = perm[nb * s:nb * s + n]
    lens = torch.from_numpy(rng.integers(0, nb * bs + 5, slots)
                            .astype(np.int32))
    lens[0] = nb * bs + 3              # the clamp at NB*BS - 1
    active = torch.from_numpy(rng.random(slots) < 0.7)
    tables = torch.from_numpy(tables)
    pool = paged_pool(1, n_blocks, bs, 2, 3, slots, torch.float32, "cpu")
    full = pool_with_spare(pool)
    assert full.shape[1] == n_blocks + 2 and pool.shape[1] == n_blocks
    old = torch.from_numpy(rng.normal(size=tuple(full.shape))
                           .astype(np.float32))
    full.copy_(old)
    new = torch.from_numpy(rng.normal(size=(slots, 2, 3)).astype(np.float32))

    rows, blk, off = paged_write_index(lens, tables, active, bs, n_blocks,
                                       spare=full.shape[1] - n_blocks)
    assert rows == slice(None) and blk.shape == off.shape == (slots,)
    full[0].index_put_((blk, off), new[rows])
    want = old[0, :n_blocks].clone()
    rows0, blk0, off0 = paged_write_index(lens, tables, active, bs, n_blocks)
    want.index_put_((blk0, off0), new[rows0])
    assert torch.equal(pool[0], want)

    kept = blk < n_blocks
    assert torch.equal(kept.nonzero().squeeze(1), rows0)
    assert not (kept & ~active).any()
    flat = blk * bs + off
    assert len(set(flat.tolist())) == slots
    for b in range(slots):
        if not kept[b]:                # a spare position, its own
            assert (int(blk[b]), int(off[b])) == (n_blocks + b // bs,
                                                  b % bs)
