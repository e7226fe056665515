"""Core of the port: the paper's analytical performance models.

* :mod:`repro_torch.core.hadoop` — faithful Hadoop MapReduce models
  (Eqs. 1-98): the pure-Python oracle, the batched torch model and the
  task-scheduler simulator.
* :mod:`repro_torch.core.whatif` — the what-if entry points (aliases of
  :mod:`repro_torch.search`).
* :mod:`repro_torch.core.tuner`  — the configuration-space optimizers
  (aliases of :mod:`repro_torch.search.strategies`).
* :mod:`repro_torch.core.roofline` — roofline terms (compute, memory,
  collective) of a step, the reference's HLO parser, and the hardware
  tables (the reference's and the H100's published figures).
* :mod:`repro_torch.core.tpu_model` — the paper's phase-decomposed model
  applied to a training or serving step on a mesh (the reference's
  arithmetic).
"""

from . import hadoop  # noqa: F401
