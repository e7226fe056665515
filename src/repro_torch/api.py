"""repro_torch.api — one facade over the port's registered cost models.

The port of the reference's ``repro.api``:

>>> import repro_torch.api as api
>>> from repro_torch.spec import JobSpec
>>> spec = JobSpec().replace(pNumMappers=64, pNumReducers=16)
>>> rep = api.model(spec, {"pSortMB": 200.0})        # typed CostReport
>>> swept = api.sweep(spec, {"pSortMB": [50., 100., 200.]})
>>> best = api.tune(spec, {"pSortMB": [50., 100., 200.]}, strategy="gradient")
>>> with api.serve(spec) as svc:                     # async what-if service
...     fut = svc.phase_query({"pSortMB": [50., 100., 200.]},
...                           phase="shuffle", total_max=300.0)

Backends register under a name (``register_model``).  A *target* below is
a :class:`~repro_torch.spec.JobSpec` (the Hadoop model), a registered
backend name plus its constructor kwargs, or an already-built evaluator.
Four backends are registered, as in the reference: the Hadoop job model
(``"hadoop"``), the accelerator step model (``"tpu"``, a numpy table model
with no device: ``cfg=`` and ``shape=``, and ``hw="h100_sxm"`` for another
hardware table than the reference's), the multi-job capacity planner
(``"cluster"``) and dollar-cost elastic provisioning (``"cloud"``).  The
others run on ``device=None`` (the CUDA card, raising without one) unless a
verb is given ``device="cpu"``.

Every evaluator behind the facade satisfies the :class:`CostModel`
protocol: a ``param_space`` describing its searchable axes (``tune``
rejects out-of-domain spaces *before* streaming them), a ``cost_key``,
batched ``evaluate``, and an optional typed ``report``.  The facade is a
thin composition over :mod:`repro_torch.search` and :mod:`repro_torch.calib`
and gives bit for bit their numbers (tested).  Its exports are frozen in
``repro_torch/spec/manifest.json``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.spec import CostReport, JobSpec, ParamSpace

__all__ = [
    "CostModel",
    "register_model",
    "available_models",
    "get_evaluator",
    "model",
    "sweep",
    "tune",
    "calibrate",
    "serve",
    "observe",
]


def observe(trace: str | None = None, **kw):
    """Turn on instrumentation for a block: ``with api.observe("out.json")
    as ob: ...`` records metrics on ``ob.registry`` and spans on
    ``ob.tracer``, and writes a Perfetto-loadable Chrome trace on exit when
    ``trace`` is given.  Delegates to :func:`repro_torch.obs.observe`."""
    from repro_torch.obs import observe as _observe

    return _observe(trace, **kw)


@runtime_checkable
class CostModel(Protocol):
    """What a cost model must expose to live behind the facade."""

    chunk: int

    @property
    def cost_key(self) -> str: ...

    @property
    def param_space(self) -> ParamSpace: ...

    def evaluate(self, overrides: Mapping[str, Any]): ...

    def exact_cost(self, assignment: Mapping[str, float]) -> float | None: ...


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, tuple[Callable[..., Any], str]] = {}

def register_model(name: str, factory: Callable[..., Any], *,
                   doc: str = "", overwrite: bool = False) -> None:
    """Register an evaluator factory under a backend name."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"cost model {name!r} is already registered")
    _REGISTRY[name] = (factory, doc)


def available_models() -> dict[str, str]:
    """Registered backend names -> one-line descriptions."""
    return {name: doc for name, (_, doc) in sorted(_REGISTRY.items())}


def _hadoop_factory(spec: JobSpec | None = None, **kw):
    from repro_torch.search.evaluator import ChunkedEvaluator, cached_evaluator

    spec = spec if spec is not None else JobSpec()
    chunk = kw.pop("chunk", None)
    device = kw.pop("device", None)
    if kw:     # non-default construction (dtype, model_fn): no cache
        if chunk is not None:
            kw["chunk"] = chunk
        return ChunkedEvaluator.from_spec(spec, device=device, **kw)
    return cached_evaluator(spec.params, spec.stats, spec.costs, chunk, device)


def _tpu_factory(cfg=None, shape=None, hw: str | None = None, **kw):
    from repro_torch.core.tpu_model import TpuCostFactors
    from repro_torch.search.tpu import TpuEvaluator

    if cfg is None or shape is None:
        raise TypeError(
            "the 'tpu' backend needs cfg= (a ModelConfig) and shape= "
            "(a repro_torch.configs.shapes.ShapeSpec)"
        )
    if hw is not None:
        if kw.get("costs") is not None:
            raise TypeError("pass hw= or costs=, not both")
        kw["costs"] = TpuCostFactors.for_hw(hw)
    return TpuEvaluator(cfg, shape, **kw)


def _cluster_factory(classes=None, **kw):
    from repro_torch.cluster.evaluator import ClusterEvaluator

    return ClusterEvaluator(classes, **kw)


def _cloud_factory(classes=None, **kw):
    from repro_torch.cloud import CloudEvaluator

    return CloudEvaluator(classes, **kw)


register_model(
    "hadoop", _hadoop_factory,
    doc="the paper's closed-form MapReduce job model (Eqs. 2-98), chunked",
)
register_model(
    "tpu", _tpu_factory,
    doc="TPU training-step cost model (dp/tp/n_micro/remat/ep mesh search)",
)
register_model(
    "cluster", _cluster_factory,
    doc="multi-job capacity planner (nodes + fast/slow fleet mix, slots, "
        "fifo/fair/fair_preempt/capacity policies, slowstart, arrival rate)",
)
register_model(
    "cloud", _cloud_factory,
    doc="dollar-cost elastic provisioning (on-demand/spot fleet mix, "
        "reclaim rate, autoscaler policy, dollars-per-job under an SLO)",
)


def get_evaluator(target=None, **kw) -> CostModel:
    """Resolve a facade *target* to a concrete evaluator.

    ``target`` may be a :class:`~repro_torch.spec.JobSpec` (Hadoop model), a
    registered backend name with constructor kwargs, an evaluator instance
    (returned as-is), or ``None`` (paper-default Hadoop job).
    """
    if target is None or isinstance(target, JobSpec):
        return _REGISTRY["hadoop"][0](target, **kw)
    if isinstance(target, str):
        try:
            factory, _ = _REGISTRY[target]
        except KeyError:
            raise KeyError(
                f"unknown cost model {target!r}; registered: "
                f"{sorted(_REGISTRY)}"
            ) from None
        return factory(**kw)
    if hasattr(target, "evaluate") and hasattr(target, "cost_key"):
        if kw:
            raise TypeError(
                "constructor kwargs are only valid with a JobSpec or a "
                "backend name, not an already-built evaluator"
            )
        return target
    raise TypeError(
        f"cannot resolve a cost model from {type(target).__name__}; pass a "
        "JobSpec, a registered backend name, or an evaluator"
    )


# --------------------------------------------------------------------------
# the facade verbs
# --------------------------------------------------------------------------


def _as_rows(overrides: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Scalars -> 1-row columns so single-config probes fit ``evaluate``."""
    rows = {k: np.atleast_1d(np.asarray(v, dtype=np.float64))
            for k, v in overrides.items()}
    if not rows:
        raise ValueError("at least one override is required")
    return rows


def model(target=None, assignment: Mapping[str, float] | None = None,
          **kw) -> CostReport:
    """Cost one configuration; returns the typed :class:`CostReport`.

    ``assignment`` maps config keys to scalars (defaults to the target's
    base configuration).  For backends without phase reports, a
    :class:`repro_torch.search.SearchResult` is returned instead.
    """
    ev = get_evaluator(target, **kw)
    if assignment:
        rows = _as_rows(assignment)
    else:
        base = getattr(ev, "base_cfg", None)
        if base is None:
            raise ValueError(
                "this backend has no base configuration; pass an assignment")
        key = next(iter(base))
        rows = {key: np.atleast_1d(float(base[key]))}
    return sweep(ev, rows)


def sweep(target=None, overrides: Mapping[str, Any] | None = None, **kw):
    """Batched evaluation; returns a :class:`CostReport` with ``(B,)``
    leaves (or a plain :class:`SearchResult` for report-less backends).

    ``overrides`` follows the evaluator contract: 1-D arrays sweep, scalars
    pin — the same rows a ``ChunkedEvaluator.evaluate`` call would take, and
    bit-for-bit the same numbers.
    """
    ev = get_evaluator(target, **kw)
    if not overrides:
        raise ValueError("sweep() needs an overrides mapping")
    rep = ev.report(overrides) if hasattr(ev, "report") else None
    return rep if rep is not None else ev.evaluate(overrides)


_STRATEGIES = ("grid", "random", "descent", "gradient", "topk")


def tune(target=None, space: Mapping[str, Sequence[float]] | None = None, *,
         strategy: str = "grid", k: int = 10, exact_fallback: bool = True,
         strategy_kw: Mapping[str, Any] | None = None, **kw):
    """Search ``space`` for the cheapest configuration.

    ``strategy`` is ``"grid"`` (exhaustive streamed top-k=1), ``"random"``,
    ``"descent"`` (coordinate descent), ``"gradient"`` (differentiates the
    cost model itself over a continuous relaxation of the space; falls back
    loudly to coordinate descent on non-differentiable backends) or
    ``"topk"`` (returns the k-best ranking).  The space is validated against
    the backend's ``param_space`` — unknown axes and out-of-domain
    candidates fail here, before anything is evaluated.
    """
    from repro_torch.search.strategies import (
        coordinate_descent_ev,
        gradient_descent_ev,
        grid_search_ev,
        random_search_ev,
        search_topk,
    )

    if not space:
        raise ValueError("tune() needs a non-empty space mapping")
    if strategy not in _STRATEGIES:
        raise ValueError(f"strategy must be one of {_STRATEGIES}")
    ev = get_evaluator(target, **kw)
    ps = getattr(ev, "param_space", None)
    if ps is not None:
        space = ps.grid(space)
    skw = dict(strategy_kw or {})
    if strategy == "grid":
        return grid_search_ev(ev, space, exact_fallback=exact_fallback, **skw)
    if strategy == "random":
        return random_search_ev(ev, space, exact_fallback=exact_fallback, **skw)
    if strategy == "descent":
        return coordinate_descent_ev(ev, space, exact_fallback=exact_fallback,
                                     **skw)
    if strategy == "gradient":
        return gradient_descent_ev(ev, space, exact_fallback=exact_fallback,
                                   **skw)
    return search_topk(ev, space, k=k, exact_fallback=exact_fallback, **skw)


def calibrate(observations, params=None, **kw):
    """Fit cost factors to observed job costs by gradient descent.

    A thin alias of :func:`repro_torch.calib.calibrate` — ``observations``
    is a sequence of :class:`repro_torch.calib.Observation` (a
    :class:`JobSpec` plus its observed cost), ``params`` the factor names to
    fit (defaults to all :data:`repro_torch.calib.COST_FACTOR_NAMES`);
    ``device=None`` fits on the CUDA card.  Returns the typed
    :class:`~repro_torch.spec.CalibrationReport`.
    """
    from repro_torch.calib import calibrate as _calibrate

    return _calibrate(observations, params, **kw)


def serve(target=None, *, keys: Sequence[str] | None = None,
          window_s: float = 0.0, **kw):
    """An async :class:`~repro_torch.search.service.WhatIfService` over the
    target.

    Supports the full query surface — probes, sweeps, grids, and the typed
    per-phase queries (:meth:`WhatIfService.phase_query`: e.g. minimize
    shuffle time subject to a total-cost budget).  Use as a context manager.
    """
    from repro_torch.search.service import WhatIfService

    ev = get_evaluator(target, **kw)
    return WhatIfService(ev, keys=keys, window_s=window_s)
