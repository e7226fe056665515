"""Core of the port: the paper's analytical performance models.

* :mod:`repro_torch.core.hadoop` — faithful Hadoop MapReduce models
  (Eqs. 1-98): the pure-Python oracle, the batched torch model and the
  task-scheduler simulator.
* :mod:`repro_torch.core.whatif` — the what-if entry points (aliases of
  :mod:`repro_torch.search`).
* :mod:`repro_torch.core.tuner`  — the configuration-space optimizers
  (aliases of :mod:`repro_torch.search.strategies`).
"""

from . import hadoop  # noqa: F401
