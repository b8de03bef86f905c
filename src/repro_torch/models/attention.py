"""GQA attention: chunked online-softmax reference + KV-cache decode.

Counterpart of ``repro/models/attention.py``: grouped KV heads (GQA/MQA),
qk-norm (qwen3), QKV bias (qwen2), RoPE and M-RoPE (qwen2-vl), and the
bidirectional self-attention and cross-attention of an encoder-decoder
(whisper).  Training runs :func:`chunked_attention` in plain PyTorch, as
the reference runs its jnp path there.  Every full-sequence product,
causal or not, goes through ``kernels/flash_attention`` wherever no
gradient is taken (prefill, an encoder's forward, an eval step), and every
decode path (the engine's slotted and paged steps, the scalar step of its
oracle, and an encoder-decoder's cross-attention at decode) through
``kernels/decode_attention``: the hand-written CUDA kernels for CUDA
tensors, their plain versions on the CPU (and :func:`chunked_attention`
under autograd: the flash kernel has no backward).  Every kernel call of
the models goes through this module, so a caller that swaps its
``flash_attention`` or ``decode_attention`` swaps them everywhere.

Decode writes the new K/V row into the cache or pool *in place* (the
reference's ``dynamic_update_slice`` and ``.at[].set`` return new arrays);
the functions still return the caches so call sites read like the
reference's.

Under a mesh (DTensor inputs) every kernel call runs on this rank's local
shards (:func:`repro_torch.distributed.sharding.local_call`): q's heads
split over the ``heads`` rule's mesh axis, batch over ``batch``'s, and
k and v replicated over the head axis (the ``kv_heads`` rule is None), of
which each rank hands the kernel the KV heads its q heads read (qwen3-4b
at 16-way TP: 2 q heads of 1 KV head a rank).  The kernel takes a whole
``head_dim``, so a decode cache sharded on ``head_dim`` (the ``head_dim``
rule) is all-gathered over that axis at each call, one layer at a time:
the dry run counts those bytes as all-gather traffic.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    is_dtensor,
    local_call,
    logical_placements,
    mesh_rank,
    replicated_like,
)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import glue
from repro_torch.models.common import (
    apply_mrope,
    apply_rope,
    dense_init,
    rmsnorm,
)
from repro_torch.models.glue import grad_taken as _grad_taken

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    d, h, kvh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    p = {
        "q": dense_init(gen, (d, h * hd), d),
        "k": dense_init(gen, (d, kvh * hd), d),
        "v": dense_init(gen, (d, kvh * hd), d),
        "o": dense_init(gen, (h * hd, d), h * hd),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["q_b"] = torch.zeros((h * hd,), dtype=torch.float32, device=dev)
        p["k_b"] = torch.zeros((kvh * hd,), dtype=torch.float32, device=dev)
        p["v_b"] = torch.zeros((kvh * hd,), dtype=torch.float32, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def attention_specs(cfg: ModelConfig, prefix: Tuple = ()
                    ) -> Dict[str, Tuple]:
    """Logical axes per param dim, as ``repro``'s."""
    p = {
        "q": prefix + ("embed", "heads"),
        "k": prefix + ("embed", "kv_heads"),
        "v": prefix + ("embed", "kv_heads"),
        "o": prefix + ("heads", "embed"),
    }
    if cfg.qkv_bias:
        p["q_b"] = prefix + ("heads",)
        p["k_b"] = prefix + ("kv_heads",)
        p["v_b"] = prefix + ("kv_heads",)
    if cfg.qk_norm:
        p["q_norm"] = prefix + (None,)
        p["k_norm"] = prefix + (None,)
    return p


# ---------------------------------------------------------------------------
# Core contraction: chunked online-softmax attention
# ---------------------------------------------------------------------------


N_CAUSAL_Q_BLOCKS = 8


def chunked_attention(
    q: torch.Tensor,           # (B, Sq, H, hd)
    k: torch.Tensor,           # (B, Sk, KVH, hd)
    v: torch.Tensor,           # (B, Sk, KVH, hd)
    *,
    causal: bool,
    chunk: int = 512,
    q_offset: int = 0,         # absolute position of q[0]
    kv_len: Union[int, torch.Tensor, None] = None,  # valid KV prefix
    block_causal: bool = True,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks. Returns (B, Sq, H, hd).

    Causal full-sequence calls are q-blocked: the query range is split into
    ``N_CAUSAL_Q_BLOCKS`` blocks, each attending only to its causal KV
    prefix, which skips the fully masked chunks a single pass would
    compute and discard.
    """
    b, sq, h, hd = q.shape
    if (block_causal and causal and kv_len is None and sq == k.shape[1]
            and q_offset == 0 and sq >= 2 * chunk
            and sq % N_CAUSAL_Q_BLOCKS == 0):
        qb = sq // N_CAUSAL_Q_BLOCKS
        outs = []
        for i in range(N_CAUSAL_Q_BLOCKS):
            hi = (i + 1) * qb
            outs.append(chunked_attention(
                q[:, i * qb: hi], k[:, :hi], v[:, :hi],
                causal=True, chunk=chunk, q_offset=i * qb,
                block_causal=False))
        return torch.cat(outs, dim=1)
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads over {kvh} KV heads")
    rep = h // kvh
    scale = 1.0 / (hd ** 0.5)
    if sq == 1:
        # single query: no chunk loop, scores are only (B, KVH, rep, Sk).
        # ``kv_len`` is a scalar (all rows share a length) or a (B,) vector.
        qg = q.reshape(b, kvh, rep, hd).float() * scale
        s = torch.einsum("bgrd,bcgd->bgrc", qg, k.float())
        k_pos = torch.arange(sk, device=q.device)
        if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
            mask = (k_pos[None, :] < kv_len[:, None])[:, None, None, :]
        else:
            mask = k_pos < (sk if kv_len is None else kv_len)
            if causal and kv_len is None:
                mask = mask & (k_pos <= q_offset)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrc,bcgd->bgrd", p, v.float())
        return out.reshape(b, 1, h, hd).to(q.dtype)
    chunk = min(chunk, sk)
    n_chunks = (sk + chunk - 1) // chunk
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    qg = q.reshape(b, sq, kvh, rep, hd).float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)     # (Sq,)
    limit = sk if kv_len is None else kv_len
    m = torch.full((b, sq, kvh, rep), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, kvh, rep, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqgrd,bcgd->bqgrc", qg, kj)
        mask = k_pos[None, :] < limit                        # (1, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])  # (Sq, chunk)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqgrc,bcgd->bqgrd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention block forward
# ---------------------------------------------------------------------------


def _heads(y: torch.Tensor, n: int, hd: int, axis: str) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd).  Under a mesh the flattened dim is
    first placed as the rule for ``axis`` says where ``n`` heads split
    evenly, else whole: DTensor cannot view a split that cuts a head."""
    b, s, _ = y.shape
    if is_dtensor(y):
        pl = logical_placements((b, s, n), ("batch", "seq", axis),
                                y.device_mesh)
        if tuple(y.placements) != tuple(pl):
            y = y.redistribute(y.device_mesh, pl)
    return y.reshape(b, s, n, hd)


def _project_q(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = _heads(x @ p["q"].to(x.dtype), h, hd, "heads")
    if cfg.qkv_bias:
        q = q + p["q_b"].to(x.dtype).reshape(h, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 kv_src: Optional[torch.Tensor] = None):
    """q of ``x``; k and v of ``kv_src`` (cross-attention), else of ``x``."""
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    src = x if kv_src is None else kv_src
    k = _heads(src @ p["k"].to(x.dtype), kvh, hd, "kv_heads")
    v = _heads(src @ p["v"].to(x.dtype), kvh, hd, "kv_heads")
    if cfg.qkv_bias:
        k = k + p["k_b"].to(x.dtype).reshape(kvh, hd)
        v = v + p["v_b"].to(x.dtype).reshape(kvh, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return _project_q(p, x, cfg), k, v


def _rotate(q, k, positions: Optional[torch.Tensor], cfg: ModelConfig):
    """RoPE at (B, S) positions (0..S-1 where None), or M-RoPE at (3, B,
    S) ones: a glue site (``models/glue.py``)."""
    if glue.fused(cfg, q, k):
        return glue.rope(q, k, positions, cfg)
    glue.site("torch")
    if positions is None:
        positions = _arange_positions(q.shape[0], q.shape[1], q.device)
    axes = ("batch", "seq") if positions.dim() == 2 else (None, "batch",
                                                          "seq")
    positions = replicated_like(positions, q, axes)
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta,
                            cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _decode_positions(at: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One decode step's positions from ``at`` (B,): (B, 1), or for M-RoPE
    (3, B, 1), each of the three components at ``at``, as the
    reference's decode paths broadcast their position."""
    if cfg.mrope:
        return at[None, :, None].expand(3, -1, 1)
    return at[:, None]


def _rank_heads(q_pl, mesh, h: int, kvh: int, dim: int):
    """(q's placements, this rank's slice of the KV heads): the KV heads
    the rank's q heads read under GQA.  Where a rank's q heads would
    straddle KV-head groups unevenly, q's heads are not split."""
    from torch.distributed.tensor import Replicate, Shard

    idx, n = mesh_rank(mesh, q_pl, dim)
    if n == 1:
        return q_pl, slice(None)
    h_loc, rep = h // n, h // kvh
    if h_loc % rep and rep % h_loc:
        return [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in q_pl], slice(None)
    return q_pl, slice(idx * h_loc // rep, ((idx + 1) * h_loc - 1) // rep + 1)


def _gqa_call(fn, q, k, v, rest, q_axes, kv_axes, rest_axes, heads_at):
    """``fn(q, k, v, *rest)`` on local shards: q's heads (its dim
    ``heads_at``) split as the rules say, k and v replicated over that
    axis and cut to the rank's KV heads (their dim 2)."""
    mesh = (q if is_dtensor(q) else k).device_mesh
    q_pl = logical_placements(q.shape, q_axes, mesh)
    q_pl, kv = _rank_heads(q_pl, mesh, q.shape[heads_at], k.shape[2],
                           heads_at)
    kv_pl = logical_placements(k.shape, kv_axes, mesh)
    rest_pl = [logical_placements(t.shape, a, mesh)
               for t, a in zip(rest, rest_axes)]

    def local(ql, kl, vl, *rl):
        return fn(ql.contiguous(), kl[:, :, kv].contiguous(),
                  vl[:, :, kv].contiguous(), *(t.contiguous() for t in rl))
    return local_call(local, (q, k, v, *rest), (q_pl, kv_pl, kv_pl,
                                                *rest_pl), (q_pl,))


def _attend(q, k, v, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """A full-sequence product: the flash-attention op where no gradient
    is taken, ``chunked_attention`` (the reference's function) under
    autograd, since the flash kernel has no backward."""
    if is_dtensor(q):
        return _gqa_call(lambda ql, kl, vl: _attend(ql, kl, vl, cfg, causal),
                         q, k, v, (), ("batch", None, "heads", None),
                         ("batch", None, None, None), (), 2)
    if _grad_taken(q, k, v):
        return chunked_attention(q, k, v, causal=causal,
                                 chunk=cfg.attn_chunk)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal)


def attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, use_rope: bool = True
                    ) -> torch.Tensor:
    """Self-attention over a full sequence (train / eval, an encoder).
    ``positions``: (B, S), or (3, B, S) for M-RoPE."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        q, k = _rotate(q, k, positions, cfg)
    out = _attend(q, k, v, cfg, causal)
    return out.reshape(b, s, -1) @ p["o"].to(x.dtype)


def cross_attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          enc_out: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """Cross-attention (whisper's decoder): queries from ``x``, keys and
    values from ``enc_out``, no mask."""
    return cross_attention_prefill(p, x, enc_out, cfg)[0]


def cross_attention_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor,
                            enc_out: torch.Tensor, cfg: ModelConfig):
    """:func:`cross_attention_block` that also returns the cross cache
    ``(ck, cv)``, each (B, T_enc, KVH, hd), for the decode steps (the
    reference's ``encdec_prefill`` computes them once from ``enc_out``)."""
    b, s, _ = x.shape
    q, ck, cv = _project_qkv(p, x, cfg, kv_src=enc_out)
    out = _attend(q, ck, cv, cfg, causal=False)
    return out.reshape(b, s, -1) @ p["o"].to(x.dtype), (ck, cv)


def _decode(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """The decode-attention op: q (B, H, hd) over caches (B, S, KVH, hd)
    to ``kv_len`` (B,); on local shards under a mesh."""
    if is_dtensor(q) or is_dtensor(k_cache):
        return _gqa_call(decode_attention, q, k_cache, v_cache, (kv_len,),
                         ("batch", "heads", None),
                         ("batch", None, None, None), (("batch",),), 1)
    return decode_attention(q, k_cache, v_cache, kv_len)


def _paged_decode(q, k_pool, v_pool, tables, kv_len) -> torch.Tensor:
    """The paged decode-attention op: q (B, H, hd) over pools (P, BS, KVH,
    hd) through ``tables`` (B, NB); on local shards under a mesh (the
    pools whole on every rank but for their KV heads)."""
    if is_dtensor(q) or is_dtensor(k_pool):
        return _gqa_call(paged_decode_attention, q, k_pool, v_pool,
                         (tables, kv_len), ("batch", "heads", None),
                         (None, None, None, None),
                         (("batch", None), ("batch",)), 1)
    return paged_decode_attention(q, k_pool, v_pool, tables, kv_len)


def cross_attention_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
    """One decode step's cross-attention over the cross cache ``ck``/``cv``
    (B, T_enc, KVH, hd): every row attends to all T_enc keys.  The
    reference runs ``chunked_attention(q, ck, cv, causal=False)`` with one
    query, the function the decode-attention op computes at kv_len =
    T_enc.  Only q is projected (the reference projects k and v of ``x``
    too and drops them)."""
    b = x.shape[0]
    q = _project_q(p, x, cfg)[:, 0]
    kv_len = torch.full((b,), ck.shape[1], dtype=torch.int32,
                        device=x.device)
    out = _decode(q, ck, cv, kv_len)
    return out.reshape(b, 1, -1) @ p["o"].to(x.dtype)


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, S + pad, KVH, hd), zeros after the rows;
    under a mesh on local shards, each holding whole rows."""
    if not pad:
        return t
    if is_dtensor(t):
        pl = logical_placements(t.shape, ("batch", None, "kv_heads", None),
                                t.device_mesh)
        return local_call(lambda x: _pad_rows(x, pad), (t,), (pl,), (pl,))
    return F.pad(t, (0, 0, 0, 0, 0, pad))


def attention_prefill(p, x: torch.Tensor, cfg: ModelConfig, cache_len: int,
                      positions: Optional[torch.Tensor] = None,
                      use_rope: bool = True):
    """Prefill: returns (out, (k_cache, v_cache)) with caches padded to
    ``cache_len`` so decode can write in place (no pad, and no copy, when
    ``cache_len`` is the prompt length, as for the paged engine).  The
    causal product runs the flash-attention op; the reference runs
    ``chunked_attention``, the same function."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        q, k = _rotate(q, k, positions, cfg)
    out = _attend(q, k, v, cfg, causal=True)
    kc, vc = _pad_rows(k, cache_len - s), _pad_rows(v, cache_len - s)
    y = out.reshape(b, s, -1) @ p["o"].to(x.dtype)
    return y, (kc, vc)


def attention_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                # (B, 1, D)
    k_cache: torch.Tensor,          # (B, S_max, KVH, hd), updated in place
    v_cache: torch.Tensor,
    pos: int,                       # current length, shared by every row
    cfg: ModelConfig,
    use_rope: bool = True,
):
    """One decode step at one shared position. Returns (out, k_cache,
    v_cache); the caches are the inputs, written in place."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        at = torch.full((b,), pos, dtype=torch.int32, device=x.device)
        q, k = _rotate(q, k, _decode_positions(at, cfg), cfg)
    # dynamic_update_slice clamps its start so the row fits; so does this
    pos_w = min(pos, k_cache.shape[1] - 1)
    k_cache[:, pos_w] = k[:, 0]
    v_cache[:, pos_w] = v[:, 0]
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    out = _decode(q[:, 0], k_cache, v_cache, kv_len)[:, None]
    y = out.reshape(b, 1, -1) @ p["o"].to(x.dtype)
    return y, k_cache, v_cache


def attention_decode_slotted(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                # (B, 1, D)
    k_cache: torch.Tensor,          # (B, S_max, KVH, hd), updated in place
    v_cache: torch.Tensor,
    lens: torch.Tensor,             # (B,) int32: per-slot current lengths
    cfg: ModelConfig,
    use_rope: bool = True,
):
    """One decode step with independent per-slot sequence lengths.

    Each batch row is a serving slot at its own position: RoPE is applied
    at ``lens[b]``, the new KV row is written at ``lens[b]`` (clamped so a
    finished slot at the cache boundary overwrites its own dead tail rather
    than a neighbour), and attention masks each row to its own valid
    prefix.  Returns (out, k_cache, v_cache); the caches are the inputs,
    written in place.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        q, k = _rotate(q, k, _decode_positions(lens, cfg), cfg)
    pos_w = lens.clamp(max=k_cache.shape[1] - 1).long()
    rows = torch.arange(b, device=x.device)
    k_cache[rows, pos_w] = k[:, 0]
    v_cache[rows, pos_w] = v[:, 0]
    out = _decode(q[:, 0], k_cache, v_cache, lens + 1)[:, None]
    y = out.reshape(b, 1, -1) @ p["o"].to(x.dtype)
    return y, k_cache, v_cache


def paged_pool(layers: int, n_blocks: int, block_size: int, kv_heads: int,
               head_dim: int, slots: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """A zeroed K or V pool, (layers, n_blocks, block_size, KVH, hd): each
    layer's first ``n_blocks`` blocks of an allocation that holds
    ``ceil(slots / block_size)`` spare blocks past them, one position for
    each slot.  A decode step's masked rows write there
    (:func:`paged_write_index`); nothing reads them, and the pool does not
    show them (:func:`pool_with_spare` finds them)."""
    spare = -(-slots // block_size)
    full = torch.zeros((layers, n_blocks + spare, block_size, kv_heads,
                        head_dim), dtype=dtype, device=device)
    return full[:, :n_blocks]


def pool_with_spare(pool: torch.Tensor) -> Optional[torch.Tensor]:
    """The allocation :func:`paged_pool` cut ``pool`` from, its spare
    blocks included; None for a pool made otherwise (or a copy)."""
    full = pool._base
    if (full is None or full.dim() != pool.dim()
            or full.shape[0] != pool.shape[0]
            or full.shape[2:] != pool.shape[2:]
            or full.stride() != pool.stride()
            or full.storage_offset() != pool.storage_offset()):
        return None
    return full


def paged_write_index(lens: torch.Tensor, tables: torch.Tensor,
                      active: torch.Tensor, block_size: int, n_blocks: int,
                      spare: int = 0):
    """Where one decode step's new K/V rows go in the pool: the same for
    every layer, so a step computes it once.

    Row b writes logical position ``pos_w = min(lens[b], NB*BS - 1)``, the
    reference's clamp, to block ``tables[b, pos_w // BS]`` at offset
    ``pos_w % BS``.  Inactive rows must not touch the pool at all: a freed
    block may already belong to another slot.  The reference drops their
    write (and any write to a sentinel block) with ``mode="drop"``; torch
    has none.  With ``spare`` blocks past the pool's ``n_blocks`` (a pool
    of :func:`paged_pool`) and a spare position for every row, every row
    writes, each masked row to its own spare position, block ``n_blocks +
    b // BS`` at offset ``b % BS``: fixed shapes and no host read, so the
    step can be captured in a CUDA graph.  Otherwise only the rows that are
    active and hold a real block are kept (one host sync, for
    ``nonzero``).  Never clamp a sentinel into the pool, and no two rows
    write one position.  Returns ``(rows, blk, off)``: ``rows`` a slice of
    every row, or the (n,) indices kept, and ``blk``, ``off`` (n,) int64."""
    span = tables.shape[1] * block_size
    pos_w = lens.clamp(max=span - 1).long()
    blk = tables.gather(1, (pos_w // block_size)[:, None])[:, 0].long()
    off = pos_w % block_size
    keep = active & (blk < n_blocks)
    b = lens.shape[0]
    if spare * block_size >= b:
        row = torch.arange(b, device=lens.device)
        return (slice(None),
                torch.where(keep, blk, n_blocks + row // block_size),
                torch.where(keep, off, row % block_size))
    rows = torch.nonzero(keep).squeeze(1)
    return rows, blk[rows], off[rows]


def spare_pools(cache: Dict[str, torch.Tensor]):
    """(k, v, spare): ``cache``'s pools with their spare blocks and the
    number of those, or the pools themselves and 0 where either has
    none."""
    k, v = cache["k"], cache["v"]
    kw, vw = pool_with_spare(k), pool_with_spare(v)
    if kw is None or vw is None:
        return k, v, 0
    return kw, vw, min(kw.shape[1], vw.shape[1]) - k.shape[1]


def paged_write(cache: Dict[str, torch.Tensor], active: torch.Tensor):
    """This decode step's :func:`paged_write_index` over ``cache``'s
    pools, with their spare blocks where they have them, and the stacked
    tensors it indexes (:func:`spare_pools`): (write, k, v), of which
    layer ``i`` writes ``k[i]`` and ``v[i]``."""
    kw, vw, spare = spare_pools(cache)
    k = cache["k"]
    return (paged_write_index(cache["lens"], cache["tables"], active,
                              k.shape[2], k.shape[1], spare), kw, vw)


def attention_decode_paged(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                # (B, 1, D)
    k_pool: torch.Tensor,           # (P, BS, KVH, hd), updated in place
    v_pool: torch.Tensor,
    kv_lens: torch.Tensor,          # (B,) int32: per-slot lengths + 1
    tables: torch.Tensor,           # (B, NB) int32 block tables
    write,                          # paged_write_index(...) of this step
    dst: Tuple[torch.Tensor, torch.Tensor],  # (k, v) that write indexes
    cfg: ModelConfig,
    use_rope: bool = True,
):
    """One decode step against a paged (block-pool) KV cache.

    Per-row arithmetic as :func:`attention_decode_slotted`, but K/V live
    in a pool of fixed-size blocks addressed through each slot's block
    table.  The new K/V rows go where ``write`` (from
    :func:`paged_write_index`) says, in ``dst``: this layer's pools with
    their spare blocks, or the pools themselves (:func:`paged_write`).
    Attention runs the paged
    decode-attention kernel over the pool with ``kv_lens``, the slots'
    lengths with this step's token, made once a step for every layer; the
    token's position is ``kv_lens - 1``.  Returns (out, k_pool, v_pool);
    the pools are the inputs, written in place.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope and glue.fused(cfg, q, k, v):
        q = glue.rope_write(q, k, v, kv_lens, write, dst, cfg)
    else:
        if use_rope:
            q, k = _rotate(q, k, _decode_positions(kv_lens - 1, cfg), cfg)
        rows, blk, off = write
        dst[0].index_put_((blk, off), k[rows, 0])
        dst[1].index_put_((blk, off), v[rows, 0])
    out = _paged_decode(q[:, 0], k_pool, v_pool, tables, kv_lens)[:, None]
    y = out.reshape(b, 1, -1) @ p["o"].to(x.dtype)
    return y, k_pool, v_pool
