"""Gradient calibration of the paper's cost model against observed costs.

The paper (§4, Table 3) obtains its cost factors from micro-benchmarks; the
Starfish-style profiler (:mod:`repro_torch.mapreduce.profiler`) fits them
with a per-phase linear least squares.  Both treat the closed-form model as
a black box.  This module uses the model *itself* as the regression
function: every equation in
:func:`repro_torch.core.hadoop.model.job_model_torch` is branch-free torch
code (with straight-through round counts and double-``where`` guarded
divisions), so autograd of the predicted total cost w.r.t. any Table-2/3
parameter is exact — a handful of observed ``(JobSpec, cost)`` pairs
suffice.

Parameters are optimized in an unconstrained space via the per-axis
transforms declared on :class:`repro_torch.spec.Axis` metadata
(:meth:`Axis.relax` / :meth:`Axis.project`): positivity and bound
constraints hold by construction at every optimizer step, and cost factors
spanning 1e-9..1e-7 s/byte are fitted on a well-conditioned log scale.
The optimizer is the in-tree AdamW (:mod:`repro_torch.optim.adamw`) with
weight decay pinned to zero — decay would drag physical constants toward
zero.  The model runs on ``device`` (``None``: the CUDA card) in ``dtype``
(float64 by default, the reference's x64).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.hadoop.model import job_model_torch
from repro_torch.core.hadoop.params import CostFactors
from repro_torch.obs import current as _obs_current
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.spec import CalibrationReport, JobSpec, hadoop_space

__all__ = [
    "Observation",
    "build_loss_fn",
    "build_step",
    "calibrate",
    "observations_from_pairs",
    "COST_FACTOR_NAMES",
]

logger = logging.getLogger("repro_torch.calib")

#: the Table-3 names — the default fit target.
COST_FACTOR_NAMES: tuple[str, ...] = tuple(CostFactors.__dataclass_fields__)


@dataclass(frozen=True)
class Observation:
    """One observed execution: a fully-specified job and its measured cost.

    ``cost`` is the observed total job cost in seconds — an engine wall
    time (:class:`repro_torch.mapreduce.profiler.MeasuredRun`), a simulator
    trace total, or a replayed historical measurement.  ``weight`` scales
    this observation's contribution to the fit loss.
    """

    spec: JobSpec
    cost: float
    weight: float = 1.0

    def __post_init__(self):
        if not (self.cost > 0.0):
            raise ValueError(
                f"observation cost must be positive, got {self.cost!r}")


def observations_from_pairs(
    pairs: Iterable[tuple[JobSpec, float]]
) -> list[Observation]:
    """Replay adapter: ``(JobSpec, observed cost)`` pairs -> observations."""
    return [Observation(spec=s, cost=float(c)) for s, c in pairs]


def _stack_configs(observations: Sequence[Observation], *, dtype, device):
    packed = [o.spec.pack(dtype=dtype, device=device) for o in observations]
    return {k: torch.stack([p[k] for p in packed]) for k in packed[0]}


def build_loss_fn(cols, names: Sequence[str], y, w, space=None):
    """Build the calibration loss ``u -> weighted mean squared rel. error``.

    ``cols`` is a stacked packed-config dict, ``names`` the axes being fitted
    (``u`` maps each to its unconstrained value, a 0-d tensor), ``y``/``w``
    the observed costs and weights.  Module-level (rather than a closure
    inside :func:`calibrate`) so ``repro_torch.analysis`` can trace the exact
    loss that calibration differentiates.
    """
    space = hadoop_space() if space is None else space
    names = list(names)

    def loss_fn(u):
        cfg = dict(cols)
        for n in names:
            cfg[n] = torch.broadcast_to(space[n].project(u[n]), y.shape)
        out = job_model_torch(cfg)
        rel = (out["j_totalCost"] - y) / y
        wv = w * out["valid"].detach()
        return torch.sum(wv * rel * rel) / torch.clamp(torch.sum(wv), min=1e-12)

    return loss_fn


def build_step(loss_fn, names: Sequence[str], opt_cfg: AdamWConfig):
    """One calibration step: ``step(u, state) -> (loss, grad_norm, new_u,
    new_state)``, the loss and its gradient at ``u`` by autograd, then one
    AdamW update (``u`` maps each name to a 0-d tensor)."""
    names = list(names)

    def step(u, state):
        leaves = {n: v.detach().requires_grad_(True) for n, v in u.items()}
        loss = loss_fn(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
        new_u, new_state, metrics = adamw_update(grads, state, u, opt_cfg)
        return loss.detach(), metrics["grad_norm"], new_u, new_state

    return step


def calibrate(
    observations: Sequence[Observation],
    params: Sequence[str] | None = None,
    *,
    init: Mapping[str, float] | None = None,
    steps: int = 400,
    peak_lr: float = 0.1,
    grad_clip_norm: float = 10.0,
    history_every: int = 10,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> CalibrationReport:
    """Fit the named parameters to the observed costs by autograd.

    ``params`` may name any float axis of :func:`repro_torch.spec.hadoop_space`
    that the packed config carries — all of ``CostFactors`` by default,
    optionally ``ProfileStats`` fields.  Starting values come from ``init``
    or, per parameter, from the first observation's spec.  The loss is the
    weighted mean *squared relative error* of the model's predicted total
    (Eq. 98) against the observed cost; rows the closed forms cannot model
    (``valid == 0``) are weighted out rather than poisoning the fit.

    Returns a :class:`repro_torch.spec.CalibrationReport`; the fitted values
    are in-domain by construction (axis ``project`` transforms).  The
    reported parameters are the best seen along the trajectory, never worse
    on the fit set than the starting point.
    """
    if not observations:
        raise ValueError("calibrate() needs at least one observation")
    names = list(params) if params is not None else list(COST_FACTOR_NAMES)
    if not names:
        raise ValueError("calibrate() needs at least one parameter to fit")
    dev = resolve_device(device)
    space = hadoop_space()
    cols = _stack_configs(observations, dtype=dtype, device=dev)
    for n in names:
        ax = space[n]
        if n not in cols:
            raise KeyError(f"{n!r} is not a packed config key")
        if ax.kind != "float":
            raise ValueError(
                f"axis {n!r} is {ax.kind}; only float parameters are "
                "calibratable (int/bool knobs are search axes, not factors)")

    y = torch.tensor([o.cost for o in observations], dtype=dtype, device=dev)
    w = torch.tensor([o.weight for o in observations], dtype=dtype, device=dev)

    init = dict(init or {})
    start = {
        n: float(init.get(n, observations[0].spec[n])) for n in names
    }
    u0 = {n: torch.tensor(float(space[n].relax(start[n])), dtype=dtype,
                          device=dev) for n in names}

    # Invalid rows are weighted out of the loss below; an *all*-invalid set
    # would silently "fit" a zero loss over zero rows, so fail loudly here.
    with torch.no_grad():
        valid0 = job_model_torch(cols)["valid"]
    n_valid = int(valid0.sum())
    if n_valid == 0:
        raise ValueError(
            f"none of the {len(observations)} observations is valid under "
            "the closed-form model (merge-domain constraints, see "
            "repro_torch.spec.invalid_reasons) — there is nothing to fit"
        )
    if n_valid < len(observations):
        logger.warning(
            "calibrate: %d of %d observations are invalid under the "
            "closed-form model and will be weighted out of the fit",
            len(observations) - n_valid, len(observations),
        )

    loss_fn = build_loss_fn(cols, names, y, w, space)

    opt_cfg = AdamWConfig(
        peak_lr=peak_lr,
        warmup_steps=max(1, steps // 20),
        total_steps=steps,
        weight_decay=0.0,            # decay would pull physical constants to 0
        grad_clip_norm=grad_clip_norm,
    )
    state = adamw_init(u0)
    step = build_step(loss_fn, names, opt_cfg)

    def loss_at(u) -> float:
        with torch.no_grad():
            return float(loss_fn(u))

    u = u0
    initial_loss = loss_at(u0)
    best_loss, best_u = initial_loss, u0
    history: list[float] = [initial_loss]
    gnorm_history: list[float] = []
    ob = _obs_current()
    for i in range(steps):
        # `loss` is evaluated at the pre-update params `u` of this step
        loss, gnorm, new_u, state = step(u, state)
        fl = float(loss)
        if np.isfinite(fl) and fl < best_loss:
            best_loss, best_u = fl, u
        u = new_u
        if (i + 1) % max(1, history_every) == 0:
            history.append(fl)
            gnorm_history.append(float(gnorm))
            if ob.enabled:
                ob.tracer.counter("calibration", loss=fl,
                                  grad_norm=float(gnorm))
    final_loss = loss_at(u)
    if np.isfinite(final_loss) and final_loss < best_loss:
        best_loss, best_u = final_loss, u

    with torch.no_grad():
        fitted = {n: float(space[n].project(best_u[n])) for n in names}
    # loss/grad evaluations spent: one per step plus the two endpoint
    # loss_fn calls (the validity probe above is not a loss evaluation)
    n_model_evals = steps + 2
    report = CalibrationReport(
        fitted=fitted,
        initial=start,
        loss=best_loss,
        initial_loss=initial_loss,
        steps=steps,
        n_observations=len(observations),
        loss_history=tuple(history),
        grad_norm_history=tuple(gnorm_history),
        n_model_evals=n_model_evals,
    )
    if ob.enabled:
        ob.registry.counter("calib.runs").inc()
        ob.registry.counter("calib.steps").inc(steps)
        ob.registry.counter("calib.model_evals").inc(n_model_evals)
        ob.registry.gauge("calib.final_loss").set(best_loss)
    logger.info("calibrate: %s", report.summary())
    return report
