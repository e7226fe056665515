"""The benchmark's frozen arithmetic: published peaks, roofline bounds and
model FLOPs.

Nothing here reads the program.  The bounds are copies of
``chip_smoke.py``'s ``_flash_bound`` and ``_decode_bound``: every input
byte read once, every output byte written once, and 4 * hd FLOP per
visible (query, key) pair.  Model FLOPs count 2 * m * n * k for each matmul
over the parameters a token actually uses (the lm_head only where a logit
is computed), 4 * hd per visible (query, key) pair and head, three times
the forward for a training step (no recomputation), and, for a MoE token,
its routed top-k and its shared experts (not the capacity-padded buffers,
not every expert).
"""

from __future__ import annotations

#: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(sq: int, sk: int, *, causal: bool, window: int | None = None,
                  q_offset: int = 0, k_len: int | None = None) -> int:
    """(query, key) pairs one head of one row sees."""
    k_len = sk if k_len is None else k_len
    total = 0
    for q in range(q_offset, q_offset + sq):
        hi = min(k_len, q + 1) if causal else k_len
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_bound(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int, *,
                causal: bool, window: int | None = None, dtype_bytes: int = 2,
                ops_per_s: float = BF16_OPS_PER_S) -> dict:
    """Least time of one flash-attention call: q, k, v read once and out
    written once; 4 * hd FLOP per visible (query, key) pair."""
    pairs = visible_pairs(Sq, Sk, causal=causal, window=window) * B * H
    n_bytes = (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd) * dtype_bytes
    flop = 4.0 * hd * pairs
    return _bound(n_bytes, flop, ops_per_s)


def decode_bound(B: int, H: int, KV: int, hd: int, valid: int, *,
                 dtype_bytes: int = 2, ops_per_s: float = BF16_OPS_PER_S) -> dict:
    """Least time of one decode-attention call over ``valid`` live slots: q
    read once, the K and V rows of the live slots read once, out written
    once; 4 * hd FLOP per (head, live slot)."""
    n_bytes = (2 * B * H * hd + 2 * B * KV * valid * hd) * dtype_bytes
    flop = 4.0 * hd * B * H * valid
    return _bound(n_bytes, flop, ops_per_s)


def _bound(n_bytes: float, flop: float, ops_per_s: float) -> dict:
    bytes_s = n_bytes / HBM_BYTES_PER_S
    ops_s = flop / ops_per_s
    return {"seconds": max(bytes_s, ops_s), "bytes": n_bytes, "flop": flop,
            "by": "bytes" if bytes_s >= ops_s else "operations"}


# ------------------------------------------------------------ model FLOPs

def layer_matmul_params(cfg: dict) -> list[int]:
    """Matmul parameters one token uses in each layer, in layer order: q, k,
    v and o, then the dense MLP or the MoE's router, top-k routed and
    shared experts."""
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    gates = 3 if cfg["mlp_type"] in ("swiglu", "geglu") else 2
    out = []
    for i in range(cfg["n_layers"]):
        if cfg.get("n_experts", 0) and i >= cfg.get("moe_layer_start", 0):
            de = cfg["d_expert"]
            ffn = (d * cfg["n_experts"] + cfg["moe_top_k"] * 3 * d * de
                   + cfg.get("n_shared_experts", 0) * 3 * d * de)
        else:
            width = cfg["d_ff_dense"] if cfg.get("n_experts", 0) and cfg.get(
                "d_ff_dense") else cfg["d_ff"]
            ffn = gates * d * width
        out.append(attn + ffn)
    return out


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def attention_flop(cfg: dict, pairs: int) -> float:
    """4 * hd FLOP per visible (query, key) pair, for every head and layer."""
    return 4.0 * cfg["head_dim"] * pairs * cfg["n_heads"] * cfg["n_layers"]


def train_step_flop(cfg: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` x ``seq`` tokens:
    three times the forward (every position's logits), no recomputation."""
    tokens = rows * seq
    fwd = 2.0 * tokens * (sum(layer_matmul_params(cfg)) + head_params(cfg))
    fwd += attention_flop(cfg, rows * visible_pairs(seq, seq, causal=True))
    return 3.0 * fwd


def serve_batch_flop(cfg: dict, rows: int, prompt: int, new_tokens: int) -> float:
    """Model FLOPs of one ``throughput_batch``: the prompt's forward (logits
    at its last position only), then ``new_tokens - 1`` decode steps, each
    one token a row attending to every position up to its own."""
    body = sum(layer_matmul_params(cfg))
    steps = new_tokens - 1
    flop = 2.0 * rows * (prompt + steps) * body
    flop += 2.0 * rows * (1 + steps) * head_params(cfg)
    pairs = visible_pairs(prompt, prompt, causal=True)
    pairs += sum(prompt + j + 1 for j in range(steps))
    return flop + attention_flop(cfg, rows * pairs)
