"""Core of the port: the paper's analytical performance models.

* :mod:`repro_torch.core.hadoop` — faithful Hadoop MapReduce models
  (Eqs. 1-98): the pure-Python oracle, the batched torch model and the
  task-scheduler simulator.
"""

from . import hadoop  # noqa: F401
