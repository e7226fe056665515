"""The port's calibration stack against the JAX package's, on the CPU in
float64: AdamW, the axes' continuous relaxation, the calibration loss and
``calibrate`` itself, plus the twins of the reference's quality tests
(``tests/test_calib.py``).

Tolerances, each stated where it is used:

* ``lr_at``: rtol 1e-6 (float32; XLA's and torch's float32 cosine differ
  in the last bit at a few steps, a relative 1.2e-7).
* 50 ``adamw_update`` steps: rtol 1e-6 with atol 1e-7 on parameters and
  moments, rtol 1e-6 on the float32 grad norm and learning rate.  The first
  step is bit for bit equal (asserted); later, the float32 cosine and the
  float32 sum of squares differ in the last bit at a few steps, which moves
  a parameter by about 1e-8 absolute, and parameters that cross zero make
  a purely relative check meaningless there.
* ``relax``: rtol 1e-12; ``project``: rtol 1e-12 on float axes, int/bool
  projections exactly equal.
* ``build_loss_fn``: value and gradient at rtol 1e-9 against
  ``jax.value_and_grad``.
* ``calibrate``: fitted values, losses and the loss history at rtol 1e-6;
  the grad-norm history (float32 norms along the trajectory) at rtol 1e-5.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import Observation as JObservation
from repro.calib import calibrate as j_calibrate
from repro.calib.fit import _stack_configs as j_stack_configs
from repro.calib.fit import build_loss_fn as j_build_loss_fn
from repro.core.hadoop import params as j_params
from repro.core.hadoop.model import job_model_jnp
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import lr_at as j_lr_at
from repro.spec import JobSpec as JJobSpec
from repro.spec import hadoop_space as j_hadoop_space
from repro_torch.calib import (
    COST_FACTOR_NAMES,
    Observation,
    calibrate,
    observations_from_pairs,
)
from repro_torch.calib.fit import _stack_configs, build_loss_fn
from repro_torch.compat import has_cuda
from repro_torch.core.hadoop import params as t_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, lr_at
from repro_torch.spec import CalibrationReport, JobSpec, hadoop_space

MiB = j_params.MiB
CPU = "cpu"


def to_port(obj):
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


def to_port_spec(spec: JJobSpec) -> JobSpec:
    return JobSpec(to_port(spec.params), to_port(spec.stats), to_port(spec.costs))


# ------------------------------------------------------------------ AdamW


@pytest.mark.parametrize("cfg", [
    dict(peak_lr=0.1, warmup_steps=15, total_steps=300),   # calibrate's
    dict(peak_lr=0.5, warmup_steps=8, total_steps=80),     # gradient search's
])
def test_lr_at_matches_reference(cfg):
    j_cfg, t_cfg = JAdamWConfig(**cfg), AdamWConfig(**cfg)
    for step in range(0, cfg["total_steps"] + 10):
        want = np.asarray(j_lr_at(j_cfg, jnp.asarray(step, jnp.int32)))
        got = lr_at(t_cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_adamw_50_steps_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3,), "b": (), "c": (2, 4)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    cfg = dict(peak_lr=0.1, warmup_steps=5, total_steps=50, grad_clip_norm=1.0,
               weight_decay=0.1)
    j_cfg, t_cfg = JAdamWConfig(**cfg), AdamWConfig(**cfg)
    j_p = {k: jnp.asarray(v) for k, v in params.items()}
    t_p = {k: torch.tensor(v) for k, v in params.items()}
    j_s, t_s = j_adamw_init(j_p), adamw_init(t_p)
    for step in range(50):
        grads = {k: 3.0 * rng.standard_normal(s) for k, s in shapes.items()}
        j_p, j_s, j_m = j_adamw_update({k: jnp.asarray(v) for k, v in grads.items()},
                                       j_s, j_p, j_cfg)
        t_p, t_s, t_m = adamw_update({k: torch.tensor(v) for k, v in grads.items()},
                                     t_s, t_p, t_cfg)
        assert int(t_s["count"]) == int(j_s["count"]) == step + 1
        np.testing.assert_allclose(float(t_m["grad_norm"]), float(j_m["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(t_m["lr"]), float(j_m["lr"]), rtol=1e-6)
        for k in shapes:
            assert t_p[k].dtype == torch.float64 and t_s["m"][k].dtype == torch.float64
            for got, want in ((t_p[k], j_p[k]), (t_s["m"][k], j_s["m"][k]),
                              (t_s["v"][k], j_s["v"][k])):
                if step == 0:
                    assert got.numpy().tobytes() == np.asarray(want).tobytes(), k
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


# -------------------------------------------------- Axis.relax / project


@pytest.mark.parametrize("name", list(j_hadoop_space().names))
def test_relax_and_project_match_reference_on_every_hadoop_axis(name):
    j_ax, t_ax = j_hadoop_space()[name], hadoop_space()[name]
    assert (t_ax.kind, t_ax.lower, t_ax.upper, t_ax.lower_open) == \
        (j_ax.kind, j_ax.lower, j_ax.upper, j_ax.lower_open)
    v = float(JJobSpec()[name])
    values = np.asarray([v, v * 0.5 + 0.25, v * 2.0 + 1.0, 0.0, 1.0])
    np.testing.assert_allclose(t_ax.relax(values), j_ax.relax(values), rtol=1e-12)
    u = np.asarray([-50.0, -3.3, -1.0, -0.4, 0.0, 0.4, 0.5, 1.0, 2.7, 50.0,
                    float(j_ax.relax(v))])
    want = np.asarray(j_ax.project(jnp.asarray(u)))
    got = t_ax.project(torch.tensor(u)).numpy()
    if t_ax.kind in ("int", "bool"):
        assert np.array_equal(got, want), (got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_project_is_straight_through_on_int_axes():
    ax = hadoop_space()["pSortFactor"]
    u = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    v = ax.project(u)
    (g,) = torch.autograd.grad(v, [u])
    assert float(v.detach()) == round(float(v.detach()))
    assert float(g) == pytest.approx(float(torch.exp(u.detach())), rel=1e-15)


# ------------------------------------------------------- build_loss_fn


def _synthetic(with_noise: bool = False):
    """Observations whose costs the reference model generates at the true
    factors (optionally perturbed), as reference and port pairs."""
    base = JJobSpec(
        params=j_params.HadoopParams(pNumNodes=8, pNumMappers=64,
                                     pNumReducers=16, pSplitSize=128 * MiB),
        stats=j_params.ProfileStats(sMapSizeSel=0.8, sReduceSizeSel=0.5),
    )
    j_obs, t_obs = [], []
    for mb in (32.0, 64.0, 128.0, 256.0):
        for red in (8.0, 32.0):
            s = base.replace(pSortMB=mb, pNumReducers=red)
            out = job_model_jnp(s.pack())
            assert float(out["valid"]) == 1.0
            cost = float(out["j_totalCost"])
            if with_noise:
                cost *= 1.0 + 0.1 * np.sin(mb + red)
            j_obs.append(JObservation(spec=s, cost=cost))
            t_obs.append(Observation(spec=to_port_spec(s), cost=cost))
    return j_obs, t_obs


def test_build_loss_fn_value_and_grad_match_jax():
    j_obs, t_obs = _synthetic(with_noise=True)
    names = list(COST_FACTOR_NAMES)
    rng = np.random.default_rng(3)
    u = dict(zip(names, rng.normal(-18.0, 1.5, len(names))))
    w = np.linspace(0.5, 1.5, len(j_obs))
    y = np.asarray([o.cost for o in j_obs])
    j_loss = j_build_loss_fn(j_stack_configs(j_obs), names, jnp.asarray(y),
                             jnp.asarray(w))
    j_val, j_grad = jax.value_and_grad(j_loss)({k: jnp.asarray(v) for k, v in u.items()})
    t_loss = build_loss_fn(_stack_configs(t_obs, dtype=torch.float64, device=CPU),
                           names, torch.tensor(y), torch.tensor(w))
    leaves = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for k, v in u.items()}
    t_val = t_loss(leaves)
    t_grad = torch.autograd.grad(t_val, [leaves[k] for k in names])
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-9)
    np.testing.assert_allclose([float(g) for g in t_grad],
                               [float(j_grad[k]) for k in names], rtol=1e-9,
                               atol=0)


# ------------------------------------------------------------ calibrate


@pytest.mark.parametrize("names,steps,init_scale", [
    (["cMapCPUCost", "cSortCPUCost", "cLocalIOCost"], 300, 3.0),
    (None, 120, 1.0),
])
def test_calibrate_matches_reference(names, steps, init_scale):
    j_obs, t_obs = _synthetic(with_noise=True)
    fit = names or list(COST_FACTOR_NAMES)
    init = {n: float(j_obs[0].spec[n]) * init_scale for n in fit}
    want = j_calibrate(j_obs, names, init=init, steps=steps)
    got = calibrate(t_obs, names, init=init, steps=steps, device=CPU)
    assert isinstance(got, CalibrationReport)
    assert got.param_names == want.param_names
    assert got.initial == want.initial
    assert (got.steps, got.n_observations, got.n_model_evals) == \
        (want.steps, want.n_observations, want.n_model_evals) == \
        (steps, len(t_obs), steps + 2)
    np.testing.assert_allclose([got.fitted[n] for n in fit],
                               [want.fitted[n] for n in fit], rtol=1e-6)
    np.testing.assert_allclose([got.loss, got.initial_loss],
                               [want.loss, want.initial_loss], rtol=1e-6)
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-6)
    np.testing.assert_allclose(got.grad_norm_history, want.grad_norm_history,
                               rtol=1e-5)
    assert got.summary().splitlines()[0] == want.summary().splitlines()[0]


def test_calibrate_without_a_card_raises_unless_asked_for_the_cpu():
    if has_cuda():
        pytest.skip("a CUDA card is present: device=None runs there")
    _, t_obs = _synthetic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(t_obs, ["cMapCPUCost"], steps=2)


# ------------------------------------ twins of tests/test_calib.py quality


def test_observation_requires_positive_cost():
    with pytest.raises(ValueError, match="positive"):
        Observation(spec=JobSpec(), cost=0.0)
    with pytest.raises(ValueError, match="positive"):
        Observation(spec=JobSpec(), cost=-3.0)


def test_observations_from_pairs():
    spec = JobSpec()
    obs = observations_from_pairs([(spec, 12.5), (spec, 40.0)])
    assert [o.cost for o in obs] == [12.5, 40.0]
    assert all(o.weight == 1.0 for o in obs)


def test_calibrate_recovers_perturbed_cost_factors():
    _, obs = _synthetic()
    names = ["cMapCPUCost", "cSortCPUCost", "cLocalIOCost"]
    true = {n: float(obs[0].spec[n]) for n in names}
    init = {n: v * 3.0 for n, v in true.items()}
    report = calibrate(obs, names, init=init, steps=300, device=CPU)
    assert report.n_observations == len(obs)
    assert report.initial_loss > 1e-3          # the perturbation hurt
    assert report.loss < 1e-6                  # ...and the fit undid it
    assert report.improvement() > 0.99
    for n in names:
        assert report.initial[n] == pytest.approx(init[n])


def test_calibrate_never_worse_than_init_on_fit_set():
    _, obs = _synthetic()
    # One absurdly high learning rate: the trajectory will overshoot, but
    # best-seen selection must still report something no worse than init.
    report = calibrate(obs, ["cMapCPUCost"], steps=25, peak_lr=5.0, device=CPU)
    assert report.loss <= report.initial_loss + 1e-12


def test_calibrate_input_validation():
    obs = _synthetic()[1][:2]
    with pytest.raises(ValueError, match="at least one observation"):
        calibrate([], device=CPU)
    with pytest.raises(ValueError, match="at least one parameter"):
        calibrate(obs, [], device=CPU)
    with pytest.raises(ValueError, match="only float parameters"):
        calibrate(obs, ["pSortFactor"], device=CPU)   # int axis: a knob
    with pytest.raises(KeyError):
        calibrate(obs, ["cNoSuchFactor"], device=CPU)


def test_calibrate_raises_on_all_invalid_observations():
    # pSortMB=0.25 with pSortFactor=3 is outside the merge domain: every
    # row would be weighted out, so the fit must refuse
    bad = JobSpec().replace(pSortMB=0.25, pSortFactor=3.0)
    obs = [Observation(spec=bad, cost=10.0), Observation(spec=bad, cost=20.0)]
    with pytest.raises(ValueError, match="nothing to fit"):
        calibrate(obs, ["cMapCPUCost"], steps=5, device=CPU)


def test_calibrate_warns_on_partially_invalid_observations(caplog):
    obs = _synthetic()[1][:3]
    bad = JobSpec().replace(pSortMB=0.25, pSortFactor=3.0)
    obs.append(Observation(spec=bad, cost=10.0))
    with caplog.at_level(logging.WARNING, logger="repro_torch.calib"):
        report = calibrate(obs, ["cMapCPUCost"], steps=5, device=CPU)
    assert report.n_observations == 4
    assert any("1 of 4" in r.getMessage() for r in caplog.records)


def test_default_fit_target_is_every_cost_factor():
    assert set(COST_FACTOR_NAMES) == set(t_params.CostFactors.__dataclass_fields__)


def test_calibration_report_accessors():
    _, obs = _synthetic()
    report = calibrate(obs, ["cMapCPUCost"], steps=40, device=CPU)
    assert report.param_names == ("cMapCPUCost",)
    assert report.delta("cMapCPUCost") >= 0.0
    s = report.summary()
    assert "cMapCPUCost" in s and str(report.n_observations) in s
    assert len(report.loss_history) >= 2
