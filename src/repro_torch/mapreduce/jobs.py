"""Canonical MapReduce jobs + synthetic datasets.

A :class:`JobSpec` is the engine-facing description of a job: the map and
reduce transforms (numpy-level, dynamic shapes — task orchestration is host
code in Hadoop too), whether a combiner applies, and the byte widths used
for the paper's size accounting.

Jobs are chosen so the profile statistics (Table 2) span the interesting
regimes:

  wordcount  — expansion map (pairs sel > 1), combiner highly reductive
  sort       — identity map/reduce, selectivities exactly 1 (exact-match
               validation of the dataflow equations is possible)
  filter     — map size/pairs selectivity < 1 (grep-style), no reduce work
  aggregate  — combiner + reducer collapse to one pair per key
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

__all__ = ["JobSpec", "JOBS", "make_input"]


@dataclass
class JobSpec:
    name: str
    # map: (keys, values) -> (keys, values); dynamic output length allowed
    map_fn: Callable[[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]
    # reduce: applied per key group to the combined values
    reduce_fn: Callable[[np.ndarray], np.ndarray] | None
    use_combine: bool = False
    key_space: int = 1 << 15            # keys are ints in [0, key_space)
    pair_width: float = 100.0           # bytes per input K-V pair (accounting)
    map_out_pair_width: float = 100.0   # bytes per map-output pair
    out_pair_width: float = 100.0       # bytes per reduce-output pair
    # reduce output pairs per key group (1 = aggregate, None = identity)
    reduce_pairs_per_group: int | None = 1
    seed: int = 0
    meta: dict = field(default_factory=dict)


def make_input(
    job: JobSpec, n_pairs: int, *, seed: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic input split: (keys, values) with job-appropriate skew."""
    rng = np.random.default_rng(job.seed if seed is None else seed)
    if job.name == "wordcount":
        # records; the map tokenizes each into words (zipf-ish key skew)
        keys = rng.integers(0, job.key_space, n_pairs, dtype=np.int64)
    elif job.name == "sort":
        keys = rng.integers(0, job.key_space, n_pairs, dtype=np.int64)
    else:
        keys = rng.integers(0, job.key_space, n_pairs, dtype=np.int64)
    values = rng.random(n_pairs, dtype=np.float32)
    return keys, values


# ----------------------------------------------------------------- map fns

def _wordcount_map(keys: np.ndarray, values: np.ndarray):
    """Each record emits 4 'words'; word ids derived deterministically with a
    zipf-flavoured skew (frequent words get small ids)."""
    n = keys.shape[0]
    reps = 4
    base = np.repeat(keys, reps)
    offs = np.tile(np.arange(reps, dtype=np.int64), n)
    mixed = (base * 2654435761 + offs * 40503) % (1 << 31)
    # skew: half of all words map into a small hot set
    hot = (mixed % 2) == 0
    words = np.where(hot, mixed % 64, mixed % 8192)
    return words.astype(np.int64), np.ones(n * reps, np.float32)


def _identity_map(keys: np.ndarray, values: np.ndarray):
    return keys, values


def _filter_map(keys: np.ndarray, values: np.ndarray):
    keep = (keys % 5) == 0            # exact 20% selectivity by construction
    return keys[keep], values[keep]


def _aggregate_map(keys: np.ndarray, values: np.ndarray):
    return keys % 256, values          # collapse key space -> heavy combining


# -------------------------------------------------------------- reduce fns

def _sum_reduce(group_values: np.ndarray) -> np.ndarray:
    return np.asarray([group_values.sum()], np.float32)


def _identity_reduce(group_values: np.ndarray) -> np.ndarray:
    return group_values


JOBS: dict[str, JobSpec] = {
    "wordcount": JobSpec(
        name="wordcount",
        map_fn=_wordcount_map,
        reduce_fn=_sum_reduce,
        use_combine=True,
        key_space=1 << 15,
        pair_width=400.0,              # a text record
        map_out_pair_width=12.0,       # (word, 1)
        out_pair_width=12.0,
    ),
    "sort": JobSpec(
        name="sort",
        map_fn=_identity_map,
        reduce_fn=_identity_reduce,
        reduce_pairs_per_group=None,
        use_combine=False,
        key_space=1 << 20,
        pair_width=100.0,
        map_out_pair_width=100.0,
        out_pair_width=100.0,
    ),
    "filter": JobSpec(
        name="filter",
        map_fn=_filter_map,
        reduce_fn=_identity_reduce,
        reduce_pairs_per_group=None,
        use_combine=False,
        key_space=1 << 20,
        pair_width=200.0,
        map_out_pair_width=200.0,
        out_pair_width=200.0,
    ),
    "aggregate": JobSpec(
        name="aggregate",
        map_fn=_aggregate_map,
        reduce_fn=_sum_reduce,
        use_combine=True,
        key_space=1 << 20,
        pair_width=64.0,
        map_out_pair_width=16.0,
        out_pair_width=16.0,
    ),
}
