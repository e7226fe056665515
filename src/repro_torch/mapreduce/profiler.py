"""Starfish-style job profiler: measure Table-2 statistics and fit Table-3
cost factors from live engine runs, then predict other configurations.

This closes the paper's loop end-to-end **on real executions**:

  1. :func:`profile_job` runs the engine once and extracts the measured
     ProfileStats (selectivities, widths) — the paper's "job profile".
  2. :func:`fit_cost_factors` runs the engine over a set of configurations,
     assembles the paper's linear cost structure (every phase cost is
     Σ dataflow-quantity x cost-factor) and solves a non-negative least
     squares for the CostFactors.
  3. :func:`predict` evaluates the closed-form job model (ref.py) with the
     measured profile + fitted factors — the number Starfish would use for
     what-if analysis — and :func:`prediction_error` compares it against
     measured wall time at configs never used for fitting.
  4. :func:`fit_cost_factors_autodiff` refines the least-squares factors
     by autograd through the job model (:mod:`repro_torch.calib`) on the
     relative error of the predicted total.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.hadoop import ref
from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats
from .engine import JobCounters, MapReduceEngine
from .jobs import JobSpec, make_input

__all__ = [
    "profile_job",
    "MeasuredRun",
    "run_measured",
    "fit_cost_factors",
    "fit_cost_factors_autodiff",
    "predict",
    "prediction_error",
    "prediction_error_from_runs",
]


def profile_job(jc: JobCounters, job: JobSpec, hp: HadoopParams) -> ProfileStats:
    """Extract the paper's Table-2 statistics from measured counters."""
    in_pairs = sum(m.inputPairs for m in jc.maps)
    in_bytes = sum(m.inputBytes for m in jc.maps)
    out_pairs = sum(m.outMapPairs for m in jc.maps)
    out_bytes = sum(m.outMapSize for m in jc.maps)
    interm_ratio = 0.3 if hp.pIsIntermCompressed else 1.0
    in_ratio = 0.4 if hp.pIsInCompressed else 1.0
    uncompressed_in = in_bytes / in_ratio

    kw = dict(
        sInputPairWidth=uncompressed_in / max(in_pairs, 1),
        sMapSizeSel=out_bytes / max(uncompressed_in, 1e-12),
        sMapPairsSel=out_pairs / max(in_pairs, 1),
        sInputCompressRatio=in_ratio,
        sIntermCompressRatio=interm_ratio,
        sOutCompressRatio=0.4 if hp.pIsOutCompressed else 1.0,
    )
    # combine selectivity: measured across the first spill (paper: per-spill)
    spill_in = sum(m.spillBufferPairs * m.numSpills for m in jc.maps)
    spill_out = sum(sum(m.spillFilePairs) for m in jc.maps)
    if hp.pUseCombine and spill_in:
        sel = min(spill_out / spill_in, 1.0)
        kw.update(sCombinePairsSel=sel, sCombineSizeSel=sel)
    if jc.reduces:
        red_in = sum(r.inReducePairs for r in jc.reduces)
        red_out = sum(r.outReducePairs for r in jc.reduces)
        red_out_b = sum(r.outReduceSize for r in jc.reduces)
        red_in_b = red_in * (out_bytes / max(out_pairs, 1))
        out_ratio = kw["sOutCompressRatio"]
        kw.update(
            sReducePairsSel=red_out / max(red_in, 1),
            sReduceSizeSel=(red_out_b / out_ratio) / max(red_in_b, 1e-12),
        )
    return ProfileStats(**kw)


@dataclass
class MeasuredRun:
    hp: HadoopParams
    stats: ProfileStats
    counters: JobCounters
    wall_s: float
    phase_times: dict


def run_measured(
    job: JobSpec,
    hp: HadoopParams,
    n_pairs: int,
    *,
    seed: int = 0,
    use_kernel_combine: bool = True,
    device=None,
) -> MeasuredRun:
    """Run the engine once on seeded input and profile it.

    The combiner runs through the ``seg_combine`` kernel on ``device``
    (``None`` is CUDA; ``"cpu"`` takes its plain version) unless
    ``use_kernel_combine=False`` (the reference's ``use_pallas_combine``)
    asks for the numpy combiner; see :class:`MapReduceEngine`."""
    keys, values = make_input(job, n_pairs, seed=seed)
    eng = MapReduceEngine(hp, job, use_kernel_combine=use_kernel_combine,
                          device=device)
    t0 = time.perf_counter()
    jc = eng.run_job(keys, values)
    wall = time.perf_counter() - t0
    return MeasuredRun(hp, profile_job(jc, job, hp), jc, wall, jc.phase_totals())


# ------------------------------------------------------------------ fitting

# Design matrix columns — the subset of Table 3 identifiable from phase
# timings of an uncompressed in-memory engine (compression costs are zero
# by the paper's Initializations; IO factors fold into the same per-byte
# slots the paper uses).
_FIT_COLS = [
    "cHdfsReadCost",        # per input byte          (read phase)
    "cMapCPUCost",          # per input pair          (map phase)
    "cPartitionCPUCost",    # per map-output pair     (collect)
    "cSortCPUCost",         # per pair-comparison     (spill sort)
    "cCombineCPUCost",      # per spilled pair        (spill combine)
    "cLocalIOCost",         # per merge byte          (map+reduce merges)
    "cMergeCPUCost",        # per merged pair         (merges)
    "cNetworkCost",         # per shuffled byte       (shuffle)
    "cReduceCPUCost",       # per reduce-input pair   (reduce)
    "cHdfsWriteCost",       # per output byte         (write)
]


def _design_row(run: MeasuredRun) -> tuple[np.ndarray, np.ndarray]:
    """Phase-time observations -> (A, y) rows with the paper's structure."""
    jc = run.counters
    t = run.phase_times
    R = max(run.hp.pNumReducers, 1)

    in_bytes = sum(m.inputBytes for m in jc.maps)
    in_pairs = sum(m.inputPairs for m in jc.maps)
    out_pairs = sum(m.outMapPairs for m in jc.maps)
    spilled = sum(m.numRecSpilled for m in jc.maps)
    sort_cmp = sum(
        m.spillBufferPairs * max(np.log2(max(m.spillBufferPairs / R, 2.0)), 1.0)
        * m.numSpills
        for m in jc.maps
    )
    merge_bytes = sum(m.mergeReadBytes + m.mergeWriteBytes for m in jc.maps)
    merge_pairs = sum(m.intermDataPairs for m in jc.maps)
    shuf_bytes = sum(r.totalShuffleSize for r in jc.reduces)
    red_pairs = sum(r.inReducePairs for r in jc.reduces)
    out_bytes = sum(r.outReduceSize for r in jc.reduces)
    sort_bytes = sum(r.sortMergeReadBytes for r in jc.reduces)
    shuf_pairs = sum(sum(r.shuffleFilePairs) for r in jc.reduces)

    rows, y = [], []

    def row(**cols):
        r = np.zeros(len(_FIT_COLS))
        for k, v in cols.items():
            r[_FIT_COLS.index(k)] = v
        return r

    rows.append(row(cHdfsReadCost=in_bytes)); y.append(t.get("read", 0.0))
    rows.append(row(cMapCPUCost=in_pairs)); y.append(t.get("map", 0.0))
    rows.append(row(cPartitionCPUCost=out_pairs)); y.append(t.get("collect", 0.0))
    rows.append(row(cSortCPUCost=sort_cmp, cCombineCPUCost=spilled))
    y.append(t.get("spill", 0.0))
    rows.append(row(cLocalIOCost=merge_bytes, cMergeCPUCost=merge_pairs))
    y.append(t.get("merge", 0.0))
    rows.append(row(cNetworkCost=shuf_bytes, cMergeCPUCost=shuf_pairs))
    y.append(t.get("shuffle", 0.0))
    rows.append(row(cLocalIOCost=sort_bytes, cMergeCPUCost=red_pairs))
    y.append(t.get("sort", 0.0))
    rows.append(row(cReduceCPUCost=red_pairs, cHdfsWriteCost=out_bytes))
    y.append(t.get("reduce_write", 0.0))
    return np.stack(rows), np.asarray(y)


def fit_cost_factors(runs: list[MeasuredRun]) -> CostFactors:
    """Non-negative least squares over all phase observations."""
    A = np.concatenate([_design_row(r)[0] for r in runs])
    y = np.concatenate([_design_row(r)[1] for r in runs])
    # scale columns for conditioning
    scale = np.maximum(A.max(axis=0), 1e-12)
    x, *_ = np.linalg.lstsq(A / scale, y, rcond=None)
    x = np.maximum(x / scale, 0.0)
    kw = dict(zip(_FIT_COLS, (float(v) for v in x)))
    return CostFactors().replace(**kw)


def fit_cost_factors_autodiff(
    runs: list[MeasuredRun], *, steps: int = 250, peak_lr: float = 0.05,
    device=None,
):
    """Gradient refinement of :func:`fit_cost_factors` via
    :mod:`repro_torch.calib`.

    A thin adapter: the per-phase least-squares solution seeds an autograd
    + AdamW fit of the same ``_FIT_COLS`` against each run's measured *wall
    time*, minimizing exactly the metric :func:`prediction_error` reports
    (squared relative error of the Eq. 98 total).  The least squares is
    optimal for absolute phase-time error; the refinement re-targets the
    factors at relative total error, which is what transfers to held-out
    configurations.  Never worse than the seed on the fit runs (the
    calibrator keeps the best point seen, including the starting one).
    The job model runs on ``device`` (``None``: the CUDA card) in float64.

    Returns ``(CostFactors, CalibrationReport)``.
    """
    from repro_torch.calib import Observation, calibrate
    from repro_torch.spec import JobSpec as TypedJobSpec

    init_costs = fit_cost_factors(runs)
    obs = [
        Observation(
            spec=TypedJobSpec(params=r.hp, stats=r.stats, costs=init_costs),
            cost=r.wall_s,
        )
        for r in runs
    ]
    report = calibrate(obs, params=list(_FIT_COLS), steps=steps,
                       peak_lr=peak_lr, device=device)
    costs = init_costs.replace(**{k: report.fitted[k] for k in _FIT_COLS})
    return costs, report


def predict(
    hp: HadoopParams, stats: ProfileStats, costs: CostFactors
) -> float:
    """Closed-form total job cost (paper Eq. 98) in seconds."""
    jm = ref.job_model(hp, stats, costs)
    return jm.totalCost


def prediction_error_from_runs(
    fit_runs: list[MeasuredRun],
    test_runs: list[MeasuredRun],
    *,
    fit: str = "lstsq",
    steps: int = 250,
    device=None,
) -> dict:
    """Fit on measured runs, predict held-out runs; report relative errors.

    Taking already-measured runs (rather than configs) lets two fit methods
    be compared on the *same* executions — wall-time noise then cancels in
    the comparison.  ``fit="autodiff"`` calibrates on ``device`` (``None``:
    the CUDA card); the least-squares fit runs on the host.
    """
    if fit == "autodiff":
        costs, calibration = fit_cost_factors_autodiff(
            fit_runs, steps=steps, device=device)
    elif fit == "lstsq":
        costs, calibration = fit_cost_factors(fit_runs), None
    else:
        raise ValueError(f"unknown fit method {fit!r} (lstsq | autodiff)")
    stats = fit_runs[0].stats
    rows = []
    for run in test_runs:
        pred = predict(run.hp, run.stats, costs)
        rows.append({
            "hp": run.hp, "measured_s": run.wall_s, "predicted_s": pred,
            "rel_err": abs(pred - run.wall_s) / max(run.wall_s, 1e-9),
        })
    errs = [r["rel_err"] for r in rows]
    return {
        "costs": costs, "stats": stats, "rows": rows, "fit": fit,
        "calibration": calibration,
        "mean_rel_err": float(np.mean(errs)), "max_rel_err": float(np.max(errs)),
    }


def prediction_error(
    job: JobSpec,
    fit_hps: list[HadoopParams],
    test_hps: list[HadoopParams],
    n_pairs: int,
    *,
    seed: int = 0,
    fit: str = "lstsq",
    device=None,
) -> dict:
    """Fit on ``fit_hps``, predict ``test_hps``; report relative errors.
    The engine runs combine, and the autodiff fit runs, on ``device`` (see
    :func:`run_measured`)."""
    fit_runs = [run_measured(job, hp, n_pairs, seed=seed, device=device)
                for hp in fit_hps]
    test_runs = [run_measured(job, hp, n_pairs, seed=seed + 1, device=device)
                 for hp in test_hps]
    return prediction_error_from_runs(fit_runs, test_runs, fit=fit,
                                      device=device)
