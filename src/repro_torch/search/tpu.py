"""The accelerator-step tuner on the shared search subsystem.

The port of ``repro/search/tpu.py``: the paper's methodology applied to
step costs (:mod:`repro_torch.core.tpu_model`): rank (dp, tp, n_micro,
remat, ep) execution configurations for a model/shape *without running
them*.  The step model is pure Python over static shapes (a few hundred
candidates, microseconds each), so :class:`TpuEvaluator` is a numpy backend
with no device behind the same :class:`~repro_torch.search.evaluator.Evaluator`
interface the chunked Hadoop evaluator implements -- every strategy in
:mod:`repro_torch.search.strategies` (and ``examples/torch_tpu_tuning.py``)
runs unchanged against either cost model.  ``costs`` picks the hardware:
``TpuCostFactors.for_hw("h100_sxm")``, or the reference's table by default.

Validity here is *shardability* (the GSPMD analogue of the paper's merge
domain): a candidate is invalid when ``dp * tp`` misses the chip budget or
the global batch does not factor over (dp, n_micro).  There is no exact
escape hatch -- an unshardable mesh has no cost, exact or otherwise.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.tpu_model import TpuCostFactors, TpuParams, step_model
from repro_torch.models.config import ModelConfig
from repro_torch.spec import Axis, ParamSpace, Predicate

from .evaluator import Evaluator, NotDifferentiableError, SearchResult, masked_total
from .strategies import search_topk
from .topk import TopKResult

__all__ = ["TpuEvaluator", "tune_tpu", "mesh_space", "TPU_AXIS_NAMES"]

#: the sweepable execution-config axes (frozen in repro_torch/spec/manifest.json)
TPU_AXIS_NAMES = ("dp", "tp", "n_micro", "remat", "ep")
_SWEEPABLE = TPU_AXIS_NAMES


class TpuEvaluator(Evaluator):
    """Batched evaluation of :func:`repro_torch.core.tpu_model.step_model`.

    ``overrides`` columns may sweep any of ``dp/tp/n_micro/remat/ep``;
    unswept fields come from ``base``.  ``ep`` defaults to ``tp`` whenever
    the expert count divides it (the layout the reference's
    ``examples/tpu_tuning.py`` hillclimbed to).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        shape,                      # repro_torch.configs.shapes.ShapeSpec
        *,
        costs: TpuCostFactors | None = None,
        base: TpuParams | None = None,
        n_chips: int | None = None,
        objective: str = "overlap_s",
    ):
        self.cfg = cfg
        self.shape = shape
        self.costs = costs or TpuCostFactors()
        self.base = base or TpuParams()
        self.n_chips = n_chips
        self.objective = objective
        self._space = self._build_space()

    @property
    def cost_key(self) -> str:
        return self.objective

    @property
    def param_space(self) -> ParamSpace:
        """Declared mesh axes + shardability predicates — the GSPMD analogue
        of the paper's merge-domain validity, made inspectable."""
        return self._space

    def grad_objective(self):
        raise NotDifferentiableError(
            "the TPU step model is a pure-numpy table model over integer "
            "mesh layouts (dp/tp/n_micro are divisor-constrained ints) — "
            "there is no differentiable relaxation; gradient strategies "
            "fall back to coordinate descent here"
        )

    def _build_space(self) -> ParamSpace:
        gb = self.shape.global_batch
        preds = []
        if self.n_chips is not None:
            n = self.n_chips
            preds.append(Predicate(
                "chipBudget",
                lambda c, n=n: c["dp"] * c["tp"] == n,
                doc=f"dp * tp must equal the chip budget ({n})",
            ))
        preds.append(Predicate(
            "batchDivides",
            lambda c: gb % np.maximum(c["dp"], 1) == 0,
            doc=f"dp must divide the global batch ({gb})",
        ))
        preds.append(Predicate(
            "microDivides",
            lambda c: (c["n_micro"] == 1)
            | ((gb // np.maximum(c["dp"], 1)) % np.maximum(c["n_micro"], 1) == 0),
            doc="n_micro must divide the per-replica batch",
        ))
        axes = [
            Axis("dp", kind="int", lower=1, group="mesh", doc="data-parallel ways"),
            Axis("tp", kind="int", lower=1, group="mesh",
                 doc="tensor/model-parallel ways"),
            Axis("n_micro", kind="int", lower=1, group="mesh",
                 doc="gradient-accumulation microbatches"),
            Axis("remat", kind="bool", group="mesh",
                 doc="recompute activations in backward"),
            Axis("ep", kind="int", lower=1, group="mesh",
                 doc="expert-parallel ways (<= tp)"),
        ]
        return ParamSpace(axes, preds)

    def _row_params(self, row: Mapping[str, float]) -> TpuParams:
        kw: dict[str, Any] = {
            k: self._space.coerce(k, row[k]) for k in _SWEEPABLE if k in row
        }
        p = TpuParams(**{**_as_kwargs(self.base), **kw})
        if "ep" not in kw:
            ep = p.tp if self.cfg.n_experts and self.cfg.n_experts % p.tp == 0 else 1
            p = TpuParams(**{**_as_kwargs(p), "ep": ep})
        return p

    def _row_valid(self, p: TpuParams) -> bool:
        ok, _ = self._space.validity_mask({
            "dp": np.asarray(p.dp), "tp": np.asarray(p.tp),
            "n_micro": np.asarray(p.n_micro), "remat": np.asarray(p.remat),
            "ep": np.asarray(p.ep),
        })
        return bool(ok)

    def evaluate(self, overrides: Mapping[str, Any]) -> SearchResult:
        cols = {k: np.atleast_1d(np.asarray(v, dtype=np.float64))
                for k, v in overrides.items()}
        for k in cols:
            if k not in self._space:
                raise KeyError(f"unknown TPU config key: {k!r}")
        lengths = {v.shape[0] for v in cols.values()}
        if len(lengths) != 1:
            raise ValueError("all batched overrides must share a length")
        n = lengths.pop()
        fields = ("compute_s", "memory_s", "collective_s", "total_s",
                  "overlap_s", "valid")
        out = {f: np.zeros(n) for f in fields}
        for i in range(n):
            p = self._row_params({k: v[i] for k, v in cols.items()})
            if not self._row_valid(p):
                continue
            m = step_model(self.cfg, self.shape, p, self.costs)
            out["compute_s"][i] = m.compute_s
            out["memory_s"][i] = m.memory_s
            out["collective_s"][i] = m.collective_s
            out["total_s"][i] = m.total_s
            out["overlap_s"][i] = m.overlap_s
            out["valid"][i] = 1.0
        total = masked_total(out, self.objective)
        return SearchResult(overrides=cols, outputs=out, total_cost=total)


def _as_kwargs(p: TpuParams) -> dict:
    return {f: getattr(p, f) for f in p.__dataclass_fields__}


def mesh_space(
    n_chips: int = 256,
    micro: Sequence[int] = (1, 2, 4, 8, 16),
) -> dict[str, list[float]]:
    """Default (dp, tp, n_micro) product space for a chip budget: all dp/tp
    factorizations appear; non-factorizations are rejected by validity."""
    facs = [d for d in range(1, n_chips + 1) if n_chips % d == 0]
    return {
        "dp": [float(d) for d in facs],
        "tp": [float(n_chips // d) for d in facs],
        "n_micro": [float(m) for m in micro],
    }


def tune_tpu(
    cfg: ModelConfig,
    shape,
    *,
    n_chips: int = 256,
    space: Mapping[str, Sequence[float]] | None = None,
    costs: TpuCostFactors | None = None,
    base: TpuParams | None = None,
    objective: str = "overlap_s",
    k: int = 10,
) -> TopKResult:
    """Rank execution configs for (cfg, shape) with the shared search stack."""
    ev = TpuEvaluator(cfg, shape, costs=costs, base=base,
                      n_chips=n_chips, objective=objective)
    return search_topk(ev, space or mesh_space(n_chips),
                       k=k, exact_fallback=False)
