"""The port's roofline module (``repro_torch.core.roofline``) against the
reference's, exactly: the HLO parser on the reference's hand-written
fragment (``tests/test_roofline_parser.py``) and on the HLO of a small
``jax.jit`` program with a ``while`` loop compiled on the CPU; ``model_flops``
for all ten configs x four shapes; the hardware tables (the reference's
entry is its ``HW``; ``h100_sxm`` is NVIDIA's published figures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import roofline as j_roofline
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core import roofline

HLO = """
body.1 (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %p = (s32[], f32[8,128]) parameter(0)
  %dot.5 = f32[8,128]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar.1 = f32[8,128]{1,0} all-reduce(%dot.5), replica_groups=[16,16]<=[256], to_apply=%add.1
  %rs.1 = f32[8,8]{1,0} reduce-scatter(%ar.1), replica_groups=[16,16]<=[256], dimensions={1}
}

cond.1 (p: (s32[], f32[8,128])) -> pred[] {
  %p2 = (s32[], f32[8,128]) parameter(0)
  %c10 = s32[] constant(10)
  %lt = pred[] compare(%gte, %c10), direction=LT
}

ENTRY main (x: f32[8,64]) -> f32[8,128] {
  %a = f32[8,64]{1,0} parameter(0)
  %b = f32[64,128]{1,0} constant(0)
  %w = (s32[], f32[8,128]) while(%init), condition=%cond.1, body=%body.1
  %ag.1 = f32[128,128]{1,0} all-gather(%gte2), replica_groups=[16,16]<=[256], dimensions={0}
}
"""


def _compiled_loop_hlo() -> str:
    """A scan of 7 matmuls (a while loop in the HLO) beside one more dot."""
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=7)
        return (y @ w.T).sum()
    x = jnp.ones((8, 32), jnp.float32)
    w = jnp.ones((32, 32), jnp.float32)
    return jax.jit(f).lower(x, w).compile().as_text()


@pytest.fixture(scope="module", params=["fragment", "compiled"])
def hlo(request):
    return HLO if request.param == "fragment" else _compiled_loop_hlo()


def _stats(s):
    return (s.total_bytes, dict(s.by_kind), s.count)


def test_program_trips_and_multiplicities_equal_the_reference(hlo):
    got, want = roofline._Program(hlo), j_roofline._Program(hlo)
    assert got.body_trips == want.body_trips
    assert got.comps == want.comps
    for name in want.comps:
        assert got.eff_mult(name) == want.eff_mult(name), name


def test_loop_trip_count_is_recovered(hlo):
    prog = roofline._Program(hlo)
    assert max(prog.body_trips.values()) == (10 if hlo is HLO else 7)


def test_collectives_and_totals_equal_the_reference(hlo):
    assert _stats(roofline.collective_bytes(hlo)) == _stats(j_roofline.collective_bytes(hlo))
    assert roofline.hlo_totals(hlo) == j_roofline.hlo_totals(hlo)


def test_fragment_wire_accounting():
    stats = roofline.collective_bytes(HLO)
    ar, rs, ag = 8 * 128 * 4 * 2 * 10, 8 * 8 * 4 * 16 * 10, 128 * 128 * 4
    assert stats.by_kind == {"all-reduce": ar, "reduce-scatter": rs, "all-gather": ag}
    assert roofline.hlo_totals(HLO)["dot_flops"] == 2 * 8 * 128 * 64 * 10


def test_compiled_scan_dot_census():
    # 7 trips of an (8, 32) x (32, 32) dot, then one more dot of that size
    assert roofline.hlo_totals(_compiled_loop_hlo())["dot_flops"] == \
        2 * 8 * 32 * 32 * (7 + 1)


@pytest.mark.parametrize("cost", [{"flops": 0.0, "bytes accessed": 1e9},
                                  {"flops": 5e12, "bytes accessed": 3e11}])
def test_roofline_terms_equal_the_reference(hlo, cost):
    parsed, coll = roofline.hlo_totals(hlo), roofline.collective_bytes(hlo)
    j_parsed, j_coll = j_roofline.hlo_totals(hlo), j_roofline.collective_bytes(hlo)
    got = roofline.roofline_terms(cost, coll, 256, model_fl=1e15, parsed=parsed)
    want = j_roofline.roofline_terms(cost, j_coll, 256, model_fl=1e15, parsed=j_parsed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # without the parse, and the legacy artifact's key
    for p in (None, {"dot_flops": 1e9, "hbm_bytes": 2e12}):
        got = roofline.roofline_terms(cost, coll, 16, parsed=p)
        want = j_roofline.roofline_terms(cost, j_coll, 16, parsed=p)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(arch):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == j_roofline.model_flops(j_cfg, J_SHAPES[name])


def test_hardware_tables():
    assert roofline.HW_TABLES["tpu_v5e"] == j_roofline.HW
    assert roofline.HW is roofline.HW_TABLES["tpu_v5e"]
    assert roofline._WIRE_FACTOR == j_roofline._WIRE_FACTOR
    # NVIDIA's published H100 SXM5 80GB figures (dense bf16, HBM3, NVLink 4
    # one way), not a measurement
    assert roofline.HW_TABLES["h100_sxm"] == {
        "peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9}
    assert roofline.hw_table(None) is roofline.HW
    assert roofline.hw_table("h100_sxm") is roofline.HW_TABLES["h100_sxm"]
    with pytest.raises(KeyError, match="unknown hardware"):
        roofline.hw_table("v100")


def test_hw_selects_the_rates():
    coll = roofline.CollectiveStats(total_bytes=9e11)
    cost = {"flops": 989e12, "bytes accessed": 3.35e12}
    t = roofline.roofline_terms(cost, coll, 1, hw="h100_sxm")
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 2.0)
    assert t.bound == "collective"
    d = roofline.roofline_terms(cost, coll, 1)
    assert d.compute_s == 989e12 / j_roofline.HW["peak_flops"]
