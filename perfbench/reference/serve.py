"""Reference logits at the positions where a served batch's tokens were
chosen.

A served batch is one prompt block (B, S) and the greedy tokens the system
returned (B, n): token 0 chosen from the prompt's last position, token j
from position S + j - 1 after tokens 0..j-1 were fed back.  The reference
runs the prompt block through the model (routing capacity over the whole
block, as the system's prefill routes it) and, for the checked rows, the
served tokens 0..n-2 after it (dropless, as the system's decode routes
them), one layer at a time, and returns the logits at every position where
a token was chosen: the prompt's last position of every row, then each
checked row's generated positions.
"""

from __future__ import annotations

import torch

from .lm import Precision, decoder_layer, embed, logits

__all__ = ["chosen_logits", "gaps"]


@torch.no_grad()
def chosen_logits(w: dict, cfg: dict, prompts: torch.Tensor, served: torch.Tensor,
                  rows: list[int], capacity: int | None, prec: Precision
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (P, V) float32, the served token of each of the P positions)."""
    B, S = prompts.shape
    n = served.shape[1]
    rows_t = torch.as_tensor(rows, dtype=torch.long, device=prompts.device)
    x = embed(prompts, w)
    xg = embed(served[rows_t, :n - 1], w)
    pos_p = torch.arange(S, device=prompts.device)
    pos_g = torch.arange(S, S + n - 1, device=prompts.device)
    for i in range(cfg["n_layers"]):
        x_next, (k, v) = decoder_layer(x, w, i, cfg, pos_p, prec, capacity=capacity)
        if n > 1:
            xg, _ = decoder_layer(xg, w, i, cfg, pos_g, prec,
                                  past=(k[rows_t], v[rows_t], pos_p))
        x = x_next
    out = [logits(x[:, -1], w, cfg, prec)]
    chosen = [served[:, 0]]
    if n > 1:
        out.append(logits(xg, w, cfg, prec).flatten(0, 1))
        chosen.append(served[rows_t, 1:].flatten())
    return torch.cat(out), torch.cat(chosen)


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best at that position."""
    return ref.max(dim=-1).values - ref.gather(1, chosen[:, None])[:, 0]
