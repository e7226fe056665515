"""Streaming Cartesian config grids.

A search space is a ``Mapping[str, Sequence[float]]`` (config key ->
candidate values).  The full product is never materialized: blocks of flat
indices are unraveled into per-key value columns on demand, so a 10^6+ grid
streams through the chunked evaluator in bounded memory.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Sequence

import numpy as np

__all__ = ["space_size", "space_block", "iter_blocks", "sample_space", "assignment_at"]


def _axes(space: Mapping[str, Sequence[float]]) -> tuple[list[str], list[np.ndarray]]:
    keys = list(space.keys())
    vals = [np.asarray(list(space[k]), dtype=np.float64) for k in keys]
    for k, v in zip(keys, vals):
        if v.ndim != 1 or v.size == 0:
            raise ValueError(f"space axis {k!r} must be a non-empty 1-D sequence")
    return keys, vals


def space_size(space: Mapping[str, Sequence[float]]) -> int:
    """Number of configs in the Cartesian product."""
    _, vals = _axes(space)
    n = 1
    for v in vals:
        n *= v.size
    return n


def space_block(
    space: Mapping[str, Sequence[float]], start: int, stop: int
) -> dict[str, np.ndarray]:
    """Columns for flat product indices ``[start, stop)`` (C order: last key
    varies fastest — the order ``itertools.product`` would produce)."""
    keys, vals = _axes(space)
    shape = tuple(v.size for v in vals)
    flat = np.arange(start, stop, dtype=np.int64)
    idx = np.unravel_index(flat, shape)
    return {k: v[i] for k, v, i in zip(keys, vals, idx)}


def assignment_at(space: Mapping[str, Sequence[float]], i: int) -> dict[str, float]:
    """The single product assignment at flat index ``i``."""
    block = space_block(space, i, i + 1)
    return {k: float(v[0]) for k, v in block.items()}


def iter_blocks(
    space: Mapping[str, Sequence[float]], block: int
) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
    """Yield ``(start_index, columns)`` blocks of at most ``block`` configs."""
    n = space_size(space)
    for start in range(0, n, block):
        yield start, space_block(space, start, min(start + block, n))


def sample_space(
    space: Mapping[str, Sequence[float]], n: int, seed: int = 0
) -> dict[str, np.ndarray]:
    """Uniform i.i.d. samples from the product space (with replacement)."""
    keys, vals = _axes(space)
    rng = np.random.default_rng(seed)
    return {k: v[rng.integers(0, v.size, size=n)] for k, v in zip(keys, vals)}
