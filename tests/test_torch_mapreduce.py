"""The port's MapReduce engine and profiler against the JAX package's.

The engine is carried numpy code: its dataflow counters, outputs and
measured profiles must be identical to the reference engine's on the same
seeded input.  By default (``use_kernel_combine``) the combiner's segmented
sums go through ``repro_torch.kernels.seg_combine`` (its plain version on
the CPU):
keys exact, values at rtol 1e-5, the twin of the reference's
``test_combiner_pallas_equals_numpy``.  The least-squares fit gives the
reference's factors at rtol 1e-12 on runs with identical counters and
phase times; the autodiff refinement gives the reference's at rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.hadoop import params as j_params
from repro.mapreduce import JOBS as J_JOBS
from repro.mapreduce import MapReduceEngine as JEngine
from repro.mapreduce import make_input as j_make_input
from repro.mapreduce import profiler as j_profiler
from repro_torch.compat import has_cuda
from repro_torch.core.hadoop import params as t_params
from repro_torch.kernels import seg_combine
from repro_torch.mapreduce import JOBS, MapReduceEngine, make_input
from repro_torch.mapreduce import profiler as t_profiler

MiB = j_params.MiB
N = 12_000


def to_port(obj):
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


def _hp(job, n, **kw):
    base = dict(pNumMappers=2, pNumReducers=4, pSplitSize=n / 2 * job.pair_width,
                pUseCombine=job.use_combine, pSortMB=0.5, pSortFactor=3,
                pTaskMem=8.0 * MiB)
    base.update(kw)
    return j_params.HadoopParams(**base)


def _strip_times(jc) -> dict:
    d = dataclasses.asdict(jc)
    for side in ("maps", "reduces"):
        for c in d[side]:
            c.pop("times")
    d.pop("output")
    return d


def _run_both(name, n=N, **kw):
    hp = _hp(J_JOBS[name], n, **kw)
    keys, values = j_make_input(J_JOBS[name], n, seed=1)
    t_keys, t_values = make_input(JOBS[name], n, seed=1)
    assert np.array_equal(keys, t_keys) and np.array_equal(values, t_values)
    jc = JEngine(hp, J_JOBS[name]).run_job(keys, values)
    tc = MapReduceEngine(to_port(hp), JOBS[name],
                         use_kernel_combine=False).run_job(keys, values)
    return hp, jc, tc


@pytest.mark.parametrize("name", list(J_JOBS))
def test_engine_counters_and_profile_identical(name):
    hp, jc, tc = _run_both(name)
    assert _strip_times(tc) == _strip_times(jc)
    for a, b in zip(tc.output, jc.output):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(tc.phase_totals()) == set(jc.phase_totals())
    t_stats = t_profiler.profile_job(tc, JOBS[name], to_port(hp))
    j_stats = j_profiler.profile_job(jc, J_JOBS[name], hp)
    assert dataclasses.asdict(t_stats) == dataclasses.asdict(j_stats)


@pytest.mark.parametrize("name", ["wordcount", "aggregate"])
def test_kernel_combine_equals_numpy_combiner(name):
    job = JOBS[name]
    hp = to_port(_hp(J_JOBS[name], 8_000))
    keys, values = make_input(job, 8_000)
    jc_np = MapReduceEngine(hp, job, use_kernel_combine=False).run_job(keys, values)
    before = seg_combine.launches
    jc_k = MapReduceEngine(hp, job, device="cpu").run_job(keys, values)
    assert seg_combine.launches == before      # the CPU takes the plain version
    k1, v1 = jc_np.output
    k2, v2 = jc_k.output
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)
    assert _strip_times(jc_k) == _strip_times(jc_np)


def test_kernel_combine_flag_is_renamed_and_needs_a_device():
    job = JOBS["wordcount"]
    hp = to_port(_hp(J_JOBS["wordcount"], 1_000))
    eng = MapReduceEngine(hp, job, device="cpu")
    assert eng.use_kernel_combine is True and eng.device == torch.device("cpu")
    eng = MapReduceEngine(hp, job, use_kernel_combine=False)
    assert eng.device is None
    with pytest.raises(TypeError):
        MapReduceEngine(hp, job, use_pallas_combine=True)
    if not has_cuda():
        # the kernel combine is the default, so no card means an error
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MapReduceEngine(hp, job)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_profiler.run_measured(job, hp, 1_000)


def _measured_pairs(name, hps, n=N):
    """(port run, reference run) per config, the port's phase times replaced
    by the reference's so that both fits see identical observations."""
    out = []
    for hp in hps:
        jr = j_profiler.run_measured(J_JOBS[name], hp, n, seed=1)
        tr = t_profiler.run_measured(JOBS[name], to_port(hp), n, seed=1,
                                     device="cpu")
        assert _strip_times(tr.counters) == _strip_times(jr.counters)
        assert dataclasses.asdict(tr.stats) == dataclasses.asdict(jr.stats)
        tr = dataclasses.replace(tr, wall_s=jr.wall_s,
                                 phase_times=dict(jr.phase_times))
        out.append((tr, jr))
    return out


@pytest.mark.parametrize("name", ["sort", "wordcount"])
def test_fit_cost_factors_equal_reference(name):
    job = J_JOBS[name]
    fit_hps = [_hp(job, N), _hp(job, N, pSortMB=1.0),
               _hp(job, N, pNumReducers=8, pSortFactor=8)]
    pairs = _measured_pairs(name, fit_hps)
    t_costs = t_profiler.fit_cost_factors([t for t, _ in pairs])
    j_costs = j_profiler.fit_cost_factors([j for _, j in pairs])
    for f, want in dataclasses.asdict(j_costs).items():
        assert getattr(t_costs, f) == pytest.approx(want, rel=1e-12, abs=0), f
    for t, j in pairs:
        assert t_profiler.predict(t.hp, t.stats, t_costs) == pytest.approx(
            j_profiler.predict(j.hp, j.stats, j_costs), rel=1e-12)


def test_prediction_error_from_runs_equal_reference():
    job = J_JOBS["sort"]
    fit = _measured_pairs("sort", [_hp(job, N), _hp(job, N, pSortMB=1.0),
                                   _hp(job, N, pSortFactor=4)])
    test = _measured_pairs("sort", [_hp(job, N, pSortMB=0.75, pNumReducers=8)])
    got = t_profiler.prediction_error_from_runs(
        [t for t, _ in fit], [t for t, _ in test], fit="lstsq")
    want = j_profiler.prediction_error_from_runs(
        [j for _, j in fit], [j for _, j in test], fit="lstsq")
    assert got["mean_rel_err"] == pytest.approx(want["mean_rel_err"], rel=1e-9)
    assert got["calibration"] is None
    # the autodiff fit on the same runs: factors, calibration and held-out
    # error at rtol 1e-6 (AdamW's float32 arithmetic, as in the reference)
    got = t_profiler.prediction_error_from_runs(
        [t for t, _ in fit], [t for t, _ in test], fit="autodiff", steps=60,
        device="cpu")
    want = j_profiler.prediction_error_from_runs(
        [j for _, j in fit], [j for _, j in test], fit="autodiff", steps=60)
    assert got["fit"] == "autodiff" and got["calibration"].steps == 60
    for f, v in dataclasses.asdict(want["costs"]).items():
        assert getattr(got["costs"], f) == pytest.approx(v, rel=1e-6, abs=0), f
    assert got["calibration"].loss == pytest.approx(want["calibration"].loss,
                                                    rel=1e-6)
    assert got["calibration"].loss <= got["calibration"].initial_loss
    assert got["mean_rel_err"] == pytest.approx(want["mean_rel_err"], rel=1e-6)
    with pytest.raises(ValueError, match="lstsq"):
        t_profiler.prediction_error_from_runs(
            [t for t, _ in fit], [t for t, _ in test], fit="newton")


def test_prediction_error_combines_on_the_requested_device():
    job = J_JOBS["wordcount"]
    fit_hps = [to_port(_hp(job, 4_000)), to_port(_hp(job, 4_000, pSortMB=1.0))]
    test_hps = [to_port(_hp(job, 4_000, pNumReducers=8))]
    before = seg_combine.launches
    out = t_profiler.prediction_error(JOBS["wordcount"], fit_hps, test_hps,
                                      4_000, device="cpu")
    assert seg_combine.launches == before      # the CPU takes the plain version
    assert len(out["rows"]) == 1 and np.isfinite(out["mean_rel_err"])
    if not has_cuda():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_profiler.prediction_error(JOBS["wordcount"], fit_hps, test_hps,
                                        4_000)
