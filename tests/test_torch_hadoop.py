"""The port's Hadoop models against the JAX package's, on the CPU in float64.

Inputs are the reference's ``mapreduce.JOBS`` profiles
(``repro.cluster.workload.default_job_classes``) and ~200 configurations
drawn with ``np.random.default_rng``; both packages get the same values.
Tolerances are the reference's own: ``rel=1e-9, abs=1e-12`` for the model
(``tests/test_model_equivalence.py``), rtol 1e-9 for gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.workload import default_job_classes
from repro.core.hadoop import merge_math as j_mm
from repro.core.hadoop import model as j_model
from repro.core.hadoop import params as j_params
from repro.core.hadoop import ref as j_ref
from repro.core.hadoop import simulator as j_sim
from repro.search.evaluator import evaluate_unchunked as j_evaluate_unchunked
from repro_torch.compat import has_cuda
from repro_torch.core.hadoop import merge_math as t_mm
from repro_torch.core.hadoop import model as t_model
from repro_torch.core.hadoop import params as t_params
from repro_torch.core.hadoop import ref as t_ref
from repro_torch.core.hadoop import simulator as t_sim

MiB = j_params.MiB
PROFILES = default_job_classes()
PROFILE_IDS = [jc.name for jc in PROFILES]
REL, ABS = 1e-9, 1e-12


def to_port(obj):
    """A reference parameter dataclass as the port's own class."""
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


def draw_configs(seed: int, n: int = 200):
    """``n`` (HadoopParams, ProfileStats) pairs of the reference, spanning the
    regimes of the reference's hypothesis strategies."""
    rng = np.random.default_rng(seed)

    def pick(*vals):
        return vals[int(rng.integers(len(vals)))]

    out = []
    for _ in range(n):
        p = j_params.HadoopParams(
            pNumNodes=int(rng.integers(1, 201)),
            pNumMappers=int(rng.integers(1, 2001)),
            pNumReducers=int(rng.integers(0, 401)) if rng.random() > 0.1 else 0,
            pSplitSize=pick(16 * MiB, 64 * MiB, 128 * MiB, 256 * MiB),
            pSortMB=pick(50.0, 100.0, 200.0, 400.0),
            pSpillPerc=pick(0.6, 0.8, 0.9),
            pSortRecPerc=pick(0.05, 0.1, 0.2),
            pSortFactor=pick(5, 10, 25, 100),
            pNumSpillsForComb=pick(3, 9999),
            pInMemMergeThr=pick(10, 100, 1000),
            pShuffleInBufPerc=pick(0.5, 0.7),
            pShuffleMergePerc=pick(0.5, 0.66, 0.9),
            pReducerInBufPerc=pick(0.0, 0.3, 0.6),
            pTaskMem=pick(200.0 * MiB, 1024.0 * MiB),
            pUseCombine=bool(rng.integers(2)),
            pIsIntermCompressed=bool(rng.integers(2)),
            pIsOutCompressed=bool(rng.integers(2)),
            pIsInCompressed=bool(rng.integers(2)),
        )
        s = j_params.ProfileStats(
            sInputPairWidth=pick(24.0, 100.0, 650.0),
            sMapSizeSel=pick(0.1, 0.7, 1.0, 2.3),
            sMapPairsSel=pick(0.1, 1.0, 1.8),
            sReduceSizeSel=pick(0.1, 1.0),
            sReducePairsSel=pick(0.1, 1.0),
            sCombineSizeSel=pick(0.25, 0.8),
            sCombinePairsSel=pick(0.2, 0.7),
            sInputCompressRatio=pick(0.3, 0.6),
            sIntermCompressRatio=pick(0.3, 0.6),
            sOutCompressRatio=pick(0.3, 0.6),
        )
        out.append((p, s))
    return out


def batch_columns(triples) -> dict[str, np.ndarray]:
    """Every CONFIG_KEYS field as one float64 column over the triples."""
    cols = {k: [] for k in j_model.CONFIG_KEYS}
    for p, s, c in triples:
        for obj in (p, s, c):
            for k in obj.__dataclass_fields__:
                cols[k].append(float(getattr(obj, k)))
    return {k: np.asarray(v, dtype=np.float64) for k, v in cols.items()}


def port_outputs(cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    cfg = {k: torch.as_tensor(v) for k, v in cols.items()}
    return {k: v.numpy() for k, v in t_model.job_model_torch(cfg).items()}


def jax_outputs(cols) -> dict[str, np.ndarray]:
    # eager job_model_jnp on batched leaves.  Not through jit: XLA's fused
    # code rounds some intermediates differently, and on a few drawn rows a
    # floor() then lands one integer apart (the port agrees with the eager
    # reference bit for bit there; see test_jit_boundary_rows_are_rare).
    cfg = {k: jnp.asarray(v) for k, v in cols.items()}
    return {k: np.asarray(v) for k, v in j_model.job_model_jnp(cfg).items()}


def assert_outputs_close(got: dict, want: dict, rows=None):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if rows is not None:
            g, w = g[rows], w[rows]
        np.testing.assert_allclose(g, w, rtol=REL, atol=ABS, err_msg=k)


def _triples_profiles():
    return [(jc.params, jc.stats, jc.costs) for jc in PROFILES]


def _triples_drawn(seed):
    return [(p, s, j_params.CostFactors()) for p, s in draw_configs(seed)]


# --------------------------------------------------------------------------
# batched model against job_model_jnp: every output key
# --------------------------------------------------------------------------


@pytest.mark.parametrize("jc", PROFILES, ids=PROFILE_IDS)
def test_model_matches_jnp_on_profile(jc):
    p, s, c = jc.params, jc.stats, jc.costs
    j_out = {k: np.asarray(v) for k, v in
             j_model.job_model_jnp(j_model.pack_config(p, s, c)).items()}
    t_cfg = t_model.pack_config(to_port(p), to_port(s), to_port(c), device="cpu")
    t_out = {k: v.numpy() for k, v in t_model.job_model_torch(t_cfg).items()}
    assert_outputs_close(t_out, j_out)
    for key in ("valid", "m_mergeValid", "r_step2Valid", "r_step3Valid"):
        assert t_out[key] == j_out[key], key


@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_jnp_on_drawn_configs(seed):
    triples = _triples_drawn(seed)
    cols = batch_columns(triples)
    t_out = port_outputs(cols)
    j_out = jax_outputs(cols)
    assert_outputs_close(t_out, j_out)
    # the validity flags are exact, and the draws reach both sides of them
    for key in ("valid", "m_mergeValid", "r_step2Valid", "r_step3Valid"):
        np.testing.assert_array_equal(t_out[key], j_out[key], err_msg=key)
    assert 0 < t_out["valid"].sum() < len(triples)


def test_jit_boundary_rows_are_rare():
    """The reference's jit(vmap) path and its eager path disagree on a few
    rows where a merge count sits on a floor() boundary; the port follows
    the eager path.  Pin that it stays a handful of rows."""
    triples = _triples_drawn(0)
    cols = batch_columns(triples)
    jit_out = j_evaluate_unchunked(j_model.pack_config(*triples[0]), cols)
    t_out = port_outputs(cols)
    off = ~np.isclose(t_out["j_totalCost"], jit_out["j_totalCost"],
                      rtol=REL, atol=ABS)
    assert off.sum() <= 5


def test_model_matches_python_oracle_on_drawn_configs():
    triples = _triples_drawn(2) + _triples_profiles()
    cols = batch_columns(triples)
    t_out = port_outputs(cols)
    pairs = {
        "m_": ("map", ["inputMapSize", "inputMapPairs", "outPairWidth",
                       "intermDataSize", "intermDataPairs", "ioCost", "cpuCost"]),
    }
    map_red_fields = ["maxSerPairs", "maxAccPairs", "spillBufferPairs",
                      "numSpills", "spillFileSize", "numSpillsIntermMerge",
                      "numSpillsFinalMerge", "numMergePasses"]
    red_fields = ["segmentComprSize", "numSegInShuffleFile", "shuffleFileSize",
                  "numShuffleFiles", "numSegmentsInMem", "numShuffleMerges",
                  "numFilesOnDisk", "filesToMergeStep2", "step2MergingSize",
                  "filesToMergeStep3", "step3MergingSize", "totalMergingSize",
                  "inReduceSize", "inRedDiskSize", "ioCost", "cpuCost"]
    checked = 0
    for i, (p, s, c) in enumerate(triples):
        if t_out["valid"][i] != 1.0:
            continue        # out of the closed-form domain: the oracle simulates
        jm = t_ref.job_model(to_port(p), to_port(s), to_port(c))
        want = {f"m_{f}": getattr(jm.map, f) for f in pairs["m_"][1]}
        if p.pNumReducers > 0:
            want.update({f"m_{f}": getattr(jm.map, f) for f in map_red_fields})
            want.update({f"r_{f}": getattr(jm.reduce, f) for f in red_fields})
        want.update(j_ioJobCost=jm.ioJobCost, j_cpuJobCost=jm.cpuJobCost,
                    j_netCost=jm.netCost, j_totalCost=jm.totalCost)
        for k, w in want.items():
            assert t_out[k][i] == pytest.approx(float(w), rel=REL, abs=ABS), (i, k)
        checked += 1
    assert checked > 50


def test_pack_config_dtype_and_device_policy():
    p, s, c = (to_port(x) for x in _triples_profiles()[0])
    cfg = t_model.pack_config(p, s, c, device="cpu")
    assert all(v.dtype == torch.float64 and v.dim() == 0 for v in cfg.values())
    assert list(cfg) == list(j_model.CONFIG_KEYS)
    cfg32 = t_model.pack_config(p, s, c, dtype=torch.float32, device="cpu")
    assert all(v.dtype == torch.float32 for v in cfg32.values())
    if not has_cuda():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_model.pack_config(p, s, c)


def test_floor_mod_matches_jnp_mod_on_negative_operands():
    # jnp.mod is floor-mod (sign of the divisor): torch.remainder, not fmod
    n = np.asarray([-7.0, -1.0, 0.0, 1.0, 5.0, 9.0, 10.0, 11.0])
    f = np.asarray([3.0, 4.0, 3.0, 3.0, 3.0, 10.0, 10.0, 2.0])
    got = t_model._first_pass(torch.as_tensor(n), torch.as_tensor(f)).numpy()
    want = np.asarray(j_model._first_pass(jnp.asarray(n), jnp.asarray(f)))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# straight-through rounding
# --------------------------------------------------------------------------

STE = [("floor", t_mm.ste_floor, j_mm.ste_floor),
       ("ceil", t_mm.ste_ceil, j_mm.ste_ceil),
       ("round", t_mm.ste_round, j_mm.ste_round)]
XS = [0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, 3.5, 1.0 + 2 ** -52,
      25.05350053888, 1e15 + 0.4999, -3.75, 1e-300, 7e12,
      np.inf, -np.inf]


@pytest.mark.parametrize("name,t_fn,j_fn", STE, ids=[s[0] for s in STE])
def test_ste_forward_bit_exact(name, t_fn, j_fn):
    x = np.asarray(XS, dtype=np.float64)
    got = t_fn(torch.as_tensor(x)).numpy()
    want = np.asarray(j_fn(jnp.asarray(x)))
    assert got.tobytes() == want.tobytes(), (got, want)
    assert got.tobytes() == getattr(np, name)(x).tobytes()


@pytest.mark.parametrize("name,t_fn,j_fn", STE, ids=[s[0] for s in STE])
def test_ste_backward_passes_finite_and_zeroes_nonfinite(name, t_fn, j_fn):
    x = torch.as_tensor(np.asarray(XS + [np.nan]), dtype=torch.float64)
    x.requires_grad_(True)
    g = torch.arange(1.0, len(XS) + 2, dtype=torch.float64)
    (grad,) = torch.autograd.grad(t_fn(x), x, grad_outputs=g)
    want = torch.where(torch.isfinite(x.detach()), g, torch.zeros_like(g))
    assert torch.equal(grad, want)
    j_grad = jax.grad(lambda v: jnp.sum(j_fn(v) * jnp.asarray(g.numpy())))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(j_grad))


# --------------------------------------------------------------------------
# gradients of Eq. 98 against jax.grad
# --------------------------------------------------------------------------


@pytest.mark.parametrize("jc", PROFILES, ids=PROFILE_IDS)
def test_total_cost_grad_matches_jax(jc):
    p, s, c = jc.params, jc.stats, jc.costs
    j_cfg = j_model.pack_config(p, s, c)
    j_grad = jax.grad(lambda cfg: j_model.job_model_jnp(cfg)["j_totalCost"])(j_cfg)
    t_cfg = t_model.pack_config(to_port(p), to_port(s), to_port(c), device="cpu")
    for v in t_cfg.values():
        v.requires_grad_(True)
    total = t_model.job_model_torch(t_cfg)["j_totalCost"]
    keys = list(t_cfg)
    grads = torch.autograd.grad(total, [t_cfg[k] for k in keys],
                                allow_unused=True)
    for k, g in zip(keys, grads):
        g = 0.0 if g is None else float(g)
        assert np.isfinite(g), k
        np.testing.assert_allclose(g, float(j_grad[k]), rtol=1e-9, atol=1e-300,
                                   err_msg=k)


# --------------------------------------------------------------------------
# carried pure-Python modules: identical results
# --------------------------------------------------------------------------


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("source", ["profiles", "drawn"])
def test_carried_oracle_identical(source):
    triples = _triples_profiles() if source == "profiles" else _triples_drawn(3)[:60]
    for p, s, c in triples:
        j = j_ref.job_model(p, s, c)
        t = t_ref.job_model(to_port(p), to_port(s), to_port(c))
        assert _fields(t.map) == _fields(j.map)
        assert _fields(t.reduce) == _fields(j.reduce)
        for k in ("netCost", "ioJobCost", "cpuJobCost", "totalCost"):
            assert getattr(t, k) == getattr(j, k), k


def test_carried_merge_plan_identical():
    for n in range(0, 300, 7):
        for f in (2, 3, 5, 10, 25, 100):
            assert _fields(t_mm.merge_plan(n, f)) == _fields(j_mm.merge_plan(n, f))
            assert (_fields(t_mm.simulate_merge(n, f))
                    == _fields(j_mm.simulate_merge(n, f)))
            if n <= f * f:      # the closed forms' domain
                for name in ("calc_num_spills_first_pass",
                             "calc_num_spills_interm_merge",
                             "calc_num_spills_final_merge",
                             "num_merge_passes"):
                    assert (getattr(t_mm, name)(n, f)
                            == getattr(j_mm, name)(n, f)), (name, n, f)


SIM_CONFIGS = [
    dict(seed=7),
    dict(seed=7, straggler_prob=0.1, speculative_execution=False),
    dict(seed=7, straggler_prob=0.1, speculative_execution=True),
    dict(seed=3, node_failures=((0.3, 3),)),
]


@pytest.mark.parametrize("jc", PROFILES, ids=PROFILE_IDS)
def test_carried_simulator_identical(jc):
    p = jc.params.replace(pNumNodes=8, pNumMappers=64, pNumReducers=16)
    s, c = jc.stats, jc.costs
    for kw in SIM_CONFIGS:
        j = j_sim.simulate_job(p, s, c, j_sim.SimConfig(**kw))
        t = t_sim.simulate_job(to_port(p), to_port(s), to_port(c),
                               t_sim.SimConfig(**kw))
        assert dataclasses.asdict(t) == dataclasses.asdict(j), kw


# --------------------------------------------------------------------------
# typed layer and observability: the carried parts agree with the reference
# --------------------------------------------------------------------------


def test_hadoop_space_axes_equal_reference():
    from repro.spec import hadoop_space as j_space
    from repro_torch.spec import hadoop_space as t_space

    assert ([dataclasses.asdict(a) for a in t_space().axes]
            == [dataclasses.asdict(a) for a in j_space().axes])


@pytest.mark.parametrize("jc", PROFILES, ids=PROFILE_IDS)
def test_jobspec_pack_is_pack_config_and_from_flat_is_lossless(jc):
    from repro.spec import JobSpec as JJobSpec
    from repro_torch.spec import JobSpec

    spec = JobSpec(to_port(jc.params), to_port(jc.stats), to_port(jc.costs))
    packed = spec.pack(device="cpu")
    want = JJobSpec(jc.params, jc.stats, jc.costs).pack()
    assert list(packed) == list(want)
    for k, v in packed.items():
        assert float(v) == float(want[k]), k
    assert JobSpec.from_flat({k: float(v) for k, v in packed.items()}) == spec
    assert spec.replace(pSortMB=50.0).params.pSortMB == 50.0


def test_percentile_interp_equal_reference():
    from repro.obs import percentile_interp as j_pct
    from repro_torch.obs import percentile_interp as t_pct

    xs = sorted(np.random.default_rng(4).exponential(size=37).tolist())
    for p in (0.0, 1.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert t_pct(xs, p) == j_pct(xs, p)
