"""The executable MapReduce substrate the paper's models predict.

* :mod:`engine`   — faithful Hadoop-semantics execution (buffers, spills,
  multi-pass merges, shuffle, reduce) with exact per-phase dataflow counters;
  the combiner runs on the hand-written CUDA ``seg_combine`` kernel unless
  ``use_kernel_combine=False`` asks for numpy.
* :mod:`jobs`     — canonical benchmark jobs (wordcount, sort, filter,
  aggregate) with synthetic datasets.
* :mod:`profiler` — Starfish-style profiler: measure ProfileStats + phase
  timings from a live run; fit CostFactors; predict other configs.

The reference package's ``distributed`` pipeline (a sharded map -> combine
-> all-to-all shuffle) is not ported yet.
"""

from .engine import JobCounters, MapReduceEngine
from .jobs import JOBS, JobSpec, make_input

__all__ = ["MapReduceEngine", "JobCounters", "JobSpec", "JOBS", "make_input"]
