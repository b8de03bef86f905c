"""Operations and bytes of a dense decode step's matrix products, which the
port leaves to cuBLAS (``x @ w`` in bf16: ``models/attention.py``,
``models/transformer.py``).

Each layer of the dense family makes seven products over the step's B
rows: q, k and v from d_model, o back to d_model, gate and up to d_ff,
down back to d_model; the unembedding to the vocabulary follows once a
step.  Each product reads its (K, N) weight once, reads its (B, K) input
and writes its (B, N) output: 2 B K N operations.  A product's least time
is its own bound (``least_s(flops, bytes)``), summed over the step's
products.

``KERNELS`` are the names cuBLAS's bf16 products take in a device trace
of an H100 (torch 2.11, CUDA 12.8): the ``nvjet_*`` family (at 64 rows
of mistral-large-123b ``nvjet_tst_256x64_64x5_4x1_v_bz_NNT``,
``nvjet_tst_96x64_64x8_2x1_v_bz_NNN``, ``..._splitK_NNT`` and others),
and the reduction that follows a product split over K,
``cublasLt::splitKreduce_kernel``."""

KERNELS = ("nvjet_", "splitKreduce_kernel")


def is_gemm(name: str) -> bool:
    return any(k in name for k in KERNELS)


def flops_bytes(m: int, k: int, n: int, item: int = 2) -> tuple:
    """(operations, bytes) of one (m, k) @ (k, n) product."""
    return 2 * m * k * n, (k * n + m * k + m * n) * item


def products(cfg: dict) -> list:
    """The (K, N) of a dense layer's seven products."""
    d, h, kvh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    f = cfg["d_ff"]
    return [(d, h * hd), (d, kvh * hd), (d, kvh * hd), (h * hd, d),
            (d, f), (d, f), (f, d)]


def step_least_s(cfg: dict, rows: int, least_s) -> float:
    """Least time of one decode step's products over ``rows`` rows: every
    layer's seven, then the unembedding."""
    layer = sum(least_s(*flops_bytes(rows, k, n)) for k, n in products(cfg))
    return cfg["n_layers"] * layer \
        + least_s(*flops_bytes(rows, cfg["d_model"], cfg["vocab_size"]))
