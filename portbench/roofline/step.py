"""Operations and bytes of whole model steps of the dense and MoE LM
families, for the steps' share of the card's peak (``mfu.*``).

A decode step over B rows reads every weight once (the embedding only at
its B rows; an MoE layer's experts as far as the step reaches them), the
K/V cache at each row's live length, and writes one K/V row a layer and
B rows of logits.  Its operations are the matrix products at each row
(an MoE token through its k experts) plus attention over the live
lengths.  Experts reached: all E wherever B k >= 4 E (at 64 rows, top-4
of 16, an expert goes unreached with probability 0.75**64 < 1e-7); below
that, k of them, the fewest a step can reach (every token may choose the
same k): the bytes are then a floor and the share may read low, never
high, until the program counts the experts it reaches.

A prefill's model operations are the matrix products of every prompt
token (the unembedding only at the last one, whose logits the engine
reads) and causal attention at each prompt's own length: the work the
prompts need, not the padding or the capacity rows the program computes.
"""


def _dims(cfg: dict) -> tuple:
    d, h, kvh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    return d, h, kvh, hd


def attn_params(cfg: dict) -> int:
    d, h, kvh, hd = _dims(cfg)
    return d * h * hd * 2 + d * kvh * hd * 2


def ffn_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies by in a layer's feed-forward."""
    d = cfg["d_model"]
    if cfg["family"] == "moe":
        return d * cfg["n_experts"] + 3 * cfg["experts_per_token"] * d \
            * cfg["moe_d_ff"]
    return 3 * d * cfg["d_ff"]


def ffn_params_read(cfg: dict, n_tokens: int) -> int:
    """Weights a step over ``n_tokens`` tokens reads in a feed-forward."""
    d = cfg["d_model"]
    if cfg["family"] == "moe":
        e, k = cfg["n_experts"], cfg["experts_per_token"]
        reached = e if n_tokens * k >= 4 * e else k
        return d * e + 3 * reached * d * cfg["moe_d_ff"]
    return 3 * d * cfg["d_ff"]


def decode_flops_bytes(cfg: dict, kv_lens, item: int = 2) -> tuple:
    """One decode step over rows that attend to ``kv_lens`` positions each
    (the step's own position included)."""
    d, h, kvh, hd = _dims(cfg)
    n, v, b = cfg["n_layers"], cfg["vocab_size"], len(kv_lens)
    valid = sum(int(x) for x in kv_lens)
    per_token = n * (attn_params(cfg) + ffn_params_per_token(cfg)) + d * v
    flops = 2 * b * per_token + n * 4 * h * hd * valid
    weights = n * (attn_params(cfg) + ffn_params_read(cfg, b) + 2 * d) \
        + d * v + d + b * d
    kv = n * 2 * kvh * hd * (valid + b)      # read the live rows, write one
    nbytes = (weights + kv + b * v) * item
    return flops, nbytes


def prefill_flops(cfg: dict, prompt_lens) -> int:
    """Model operations of prefilling prompts of ``prompt_lens``."""
    d, h, kvh, hd = _dims(cfg)
    n, v = cfg["n_layers"], cfg["vocab_size"]
    per_token = n * (attn_params(cfg) + ffn_params_per_token(cfg))
    total = 0
    for p in prompt_lens:
        p = int(p)
        total += 2 * p * per_token + 2 * d * v
        total += n * 4 * h * hd * p * (p + 1) // 2
    return total
