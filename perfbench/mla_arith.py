"""The benchmark's frozen arithmetic for latent attention (MLA): the bound
of the absorbed decode kernel.  Nothing here reads the program.

One decode call of B rows at position pos reads each live latent row (slots
0 .. pos) once, R + dr values of ``dtype_bytes`` (1,152 bytes at
DeepSeek-V2-Lite's 512 + 64 in bf16), serving all H heads; q and the output
are H (R + dr) and H R values a row, read and written once.  Each (head,
live slot) costs 2 (R + dr) FLOP for the score and 2 R for the mixture.
"""

from __future__ import annotations

from perfbench.arith import BF16_OPS_PER_S, _bound

__all__ = ["decode_bound", "latent_row_bytes"]


def latent_row_bytes(cfg: dict, dtype_bytes: int = 2) -> int:
    """Bytes of one latent cache row of one layer: [c_kv | k_pe]."""
    return (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * dtype_bytes


def decode_bound(cfg: dict, rows: int, slots: int, *, dtype_bytes: int = 2,
                 ops_per_s: float = BF16_OPS_PER_S) -> dict:
    """Least time of MLA decode calls that together read ``slots`` live
    latent rows over ``rows`` (batch row, layer, step) triples: the rows'
    bytes, and each triple's q and output, at HBM bandwidth, or the FLOP at
    the bf16 peak, whichever is larger."""
    R, dr, H = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"], cfg["num_attention_heads"]
    n_bytes = slots * latent_row_bytes(cfg, dtype_bytes) + rows * H * (2 * R + dr) * dtype_bytes
    flop = slots * H * (2.0 * (R + dr) + 2.0 * R)
    return _bound(n_bytes, flop, ops_per_s)
