"""Typed job specification: the paper's three parameter tables as one value.

:class:`JobSpec` bundles the Table-1/2/3 dataclasses
(:class:`~repro_torch.core.hadoop.params.HadoopParams`,
:class:`~repro_torch.core.hadoop.params.ProfileStats`,
:class:`~repro_torch.core.hadoop.params.CostFactors`) into a single frozen,
hashable value.  Conversions are lossless both ways:

* :meth:`JobSpec.pack` -> the flat ``{key: 0-d tensor}`` config the batched
  model (:func:`repro_torch.core.hadoop.model.job_model_torch`) consumes —
  exactly ``pack_config(params, stats, costs)``.
* :meth:`JobSpec.from_flat` <- a flat float mapping, with int/bool fields
  recovered through the :func:`repro_torch.spec.axes.hadoop_space` axis kinds.

The reference package registers its ``JobSpec`` as a jax pytree; PyTorch has
no counterpart that the port needs, so this one is a plain dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import torch

from repro_torch.core.hadoop.model import CONFIG_KEYS, pack_config
from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats

from .axes import ParamSpace, hadoop_space

__all__ = ["JobSpec"]


@dataclass(frozen=True)
class JobSpec:
    """One fully-specified job: Hadoop knobs + data/UDF profile + cost factors.

    Frozen and hashable (all three members are frozen dataclasses of
    scalars), so a ``JobSpec`` can key caches the same way the ``(p, s, c)``
    triple always did.
    """

    params: HadoopParams = HadoopParams()
    stats: ProfileStats = ProfileStats()
    costs: CostFactors = CostFactors()
    name: str = ""

    # ---------------- conversions ----------------

    def pack(
        self, *, dtype: torch.dtype = torch.float64, device=None
    ) -> dict[str, torch.Tensor]:
        """The flat float config the batched model consumes (``pack_config``)."""
        return pack_config(
            self.params, self.stats, self.costs, dtype=dtype, device=device)

    @classmethod
    def from_flat(cls, cfg: Mapping[str, float], *, name: str = "") -> "JobSpec":
        """Inverse of :meth:`pack`: typed spec from a flat float mapping.

        Missing keys keep their dataclass defaults; int/bool fields are
        recovered via the axis kinds, so
        ``JobSpec.from_flat(spec.pack(device="cpu")) == spec`` exactly in
        float64 (float32 packing quantizes float fields).
        """
        space = hadoop_space()
        objs = []
        for dc_cls in (HadoopParams, ProfileStats, CostFactors):
            kw = {
                k: space.coerce(k, float(cfg[k]))
                for k in dc_cls.__dataclass_fields__
                if k in cfg
            }
            objs.append(dc_cls(**kw))
        return cls(*objs, name=name)

    def replace(self, **assignment) -> "JobSpec":
        """New spec with flat-key overrides routed onto the right table.

        Accepts the same keys as the search layer's override dicts
        (``pSortMB=200.0, pUseCombine=1.0, ...``) with axis coercion, plus
        ``name=``.
        """
        name = assignment.pop("name", self.name)
        p, s, c = hadoop_space().apply(
            assignment, self.params, self.stats, self.costs)
        unknown = [
            k for k in assignment
            if not any(k in o.__dataclass_fields__ for o in (p, s, c))
        ]
        if unknown:
            raise KeyError(f"unknown config key(s): {unknown}")
        return JobSpec(p, s, c, name=name)

    # ---------------- introspection ----------------

    @property
    def param_space(self) -> ParamSpace:
        return hadoop_space()

    def __getitem__(self, key: str) -> float:
        for obj in (self.params, self.stats, self.costs):
            if key in obj.__dataclass_fields__:
                return getattr(obj, key)
        raise KeyError(f"unknown config key: {key!r}")


assert len(CONFIG_KEYS) == sum(
    len(fields(c)) for c in (HadoopParams, ProfileStats, CostFactors)
)
