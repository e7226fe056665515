"""The executable MapReduce substrate the paper's models predict.

* :mod:`engine`   — faithful Hadoop-semantics execution (buffers, spills,
  multi-pass merges, shuffle, reduce) with exact per-phase dataflow counters;
  the combiner runs on the hand-written CUDA ``seg_combine`` kernel unless
  ``use_kernel_combine=False`` asks for numpy.
* :mod:`distributed` — the pipeline over a process group (map ->
  ``seg_combine`` -> ``all_to_all_single`` shuffle -> reduce), on NCCL for
  the card and gloo for the CPU.
* :mod:`jobs`     — canonical benchmark jobs (wordcount, sort, filter,
  aggregate) with synthetic datasets.
* :mod:`profiler` — Starfish-style profiler: measure ProfileStats + phase
  timings from a live run; fit CostFactors (least squares, then autograd);
  predict other configs.
"""

from .distributed import identity_map, make_pipeline, mapreduce_pipeline, wordcount_map
from .engine import JobCounters, MapReduceEngine
from .jobs import JOBS, JobSpec, make_input

__all__ = ["MapReduceEngine", "JobCounters", "JobSpec", "JOBS", "make_input",
           "make_pipeline", "mapreduce_pipeline", "wordcount_map",
           "identity_map"]
