"""Checks of the port that need a CUDA card; each skips, with its reason,
where there is none.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  On the card, from the repo root::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import (fixture_copy, flash_attention,
                                 gqa_decode_attention, seg_combine)
from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.fixture_copy import route as copy_route
from repro_torch.kernels.seg_combine import reduce_plan, route, seg_combine_torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel it checks runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_flash_misaligned_bf16_on_the_card_raises(cuda_device):
    # the bf16 kernel's TMA loads need 16-byte-aligned addresses; q here is
    # contiguous but starts 2 bytes past one
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((1, 4, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)))
    q = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:]
    q = q.view(1, 4, 16, 16)
    assert q.data_ptr() % 16
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_flash_misaligned_f32_on_the_card_raises(cuda_device):
    # the fp32 kernel's cp.async copies need 16-byte-aligned addresses; q
    # here is contiguous but starts 4 bytes past one
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device)
               for s in ((1, 4, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)))
    q = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:]
    q = q.view(1, 4, 16, 16)
    assert q.data_ptr() % 16
    before = flash_attention.launches
    f32_before = flash_attention.launches_by_variant["f32_3xtf32"]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    assert flash_attention.launches_by_variant["f32_3xtf32"] == f32_before


# (B, H, KV, Sq, Sk, hd, causal, window, softcap, q_offset, k_len): the fp32
# kernel's edges: every head-dim instance (hd 8, 40, 64, 128, 256, and 40
# and 136 below their instance's width), G 1, 2, 9 and 16, Sq and Sk off
# the tile sizes, windows, softcaps, an offset with k_len below Sk, rows
# that see no key (written as 0), and non-causal with Sq != Sk
F32_EDGES = {
    "hd8-G1": (1, 2, 2, 63, 65, 8, True, None, None, 2, None),
    "hd8-G16-window": (1, 16, 1, 65, 65, 8, True, 30, None, 0, None),
    "hd40-G9-softcap": (2, 9, 1, 65, 63, 40, True, None, 30.0, 0, None),
    "hd40-G9-noncausal": (1, 9, 1, 63, 2100, 40, False, None, None, 0, None),
    "hd64-G16-window-softcap": (1, 16, 1, 2100, 2100, 64, True, 100, 50.0, 0, None),
    "hd128-G2-offset-klen": (1, 4, 2, 1, 2100, 128, True, None, None, 2099, 1500),
    "hd136-G2-noncausal": (2, 4, 2, 100, 37, 136, False, None, None, 0, None),
    "hd256-G2-empty-rows": (1, 4, 2, 65, 100, 256, True, 20, 50.0, 10, 40),
    "hd256-G16-noncausal-klen": (2, 16, 1, 33, 200, 256, False, None, None, 0, 150),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F32_EDGES.values()), ids=list(F32_EDGES))
def test_flash_f32_kernel_at_its_edges(cuda_device, shape):
    from repro_torch.kernels.flash_attention import flash_attention_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, KV, Sq, Sk, hd, causal, window, cap, q_offset, k_len = shape
    rng = np.random.default_rng(Sq * 1000 + Sk + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset, k_len=k_len)
    before = flash_attention.launches_by_variant["f32_3xtf32"]
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches_by_variant["f32_3xtf32"] == before + 1
    want = flash_attention_torch(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = (want == 0).all(dim=-1)           # rows that see no key
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    if shape == F32_EDGES["hd256-G2-empty-rows"]:
        assert empty.any() and not empty.all()


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 4, 8])
@pytest.mark.parametrize("Sk,causal", [(512, True), (2100, False)],
                         ids=["causal-512", "noncausal-2100"])
def test_flash_f32_kernel_at_large_scores(cuda_device, Sk, causal, scale):
    # q and k times `scale` at hd 256, no softcap: scores of std ~scale^2
    # (tens at 4).  There the plain fp32 version is itself up to ~5e-5 from
    # the float64 value of the same inputs (its sum order rounds the
    # scores), so the kernel is held to that value instead: within 1e-5, or
    # no further than the plain fp32 version is, whichever is larger
    from repro_torch.kernels.flash_attention import flash_attention_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, KV, Sq, hd = 1, 4, 2, 512, 256
    rng = np.random.default_rng(hd + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    q, k = q * scale, k * scale
    got = flash_attention(q, k, v, causal=causal)
    plain = flash_attention_torch(q, k, v, causal=causal)
    s = torch.einsum("bngqh,bnch->bngqc", q.double().view(B, KV, H // KV, Sq, hd),
                     k.double()) * hd ** -0.5
    if causal:
        ok = torch.ones((Sq, Sk), dtype=torch.bool, device=cuda_device).tril()
        s = s.masked_fill(~ok, -torch.inf)
    exact = torch.einsum("bngqc,bnch->bngqh", torch.softmax(s, -1),
                         v.double()).reshape(B, H, Sq, hd)
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= max(1e-5, plain_err), (err, plain_err)


def _decode_inputs(device, dtype, B=2, H=8, KV=4, S=300, hd=128, seed=6):
    rng = np.random.default_rng(seed)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device, dtype)
                 for s in ((B, H, 1, hd), (B, KV, S, hd), (B, KV, S, hd)))
    slot_pos = torch.arange(S, dtype=torch.int32, device=device)
    return q, kc, vc, slot_pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["q", "k_cache"])
def test_decode_misaligned_input_on_the_card_raises(cuda_device, dtype, which):
    # the kernel's 16-byte loads need 16-byte-aligned addresses; the input
    # here is contiguous but starts one element past one
    q, kc, vc, slot_pos = _decode_inputs(cuda_device, dtype)
    args = {"q": q, "k_cache": kc}
    t = args[which]
    moved = torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)[1:]
    args[which] = moved.view(t.shape).copy_(t)
    assert args[which].data_ptr() % 16
    pos = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    before = gqa_decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        gqa_decode_attention(args["q"], args["k_cache"], vc, slot_pos, pos,
                             layout="full")
    assert gqa_decode_attention.launches == before


@pytest.mark.cuda
def test_decode_call_captured_in_a_graph_replays_at_advancing_positions(cuda_device):
    # the merge counters must be back at 0 after every replay, and the
    # kernel must read pos on the device: three replays at three positions,
    # each held to the plain version
    q, kc, vc, slot_pos = _decode_inputs(cuda_device, torch.bfloat16)
    B, H, _, hd = q.shape
    KV = kc.shape[1]
    pos = torch.tensor(0, dtype=torch.int32, device=cuda_device)
    kw = dict(window=None, logit_cap=50.0)
    gqa_decode_attention(q, kc, vc, slot_pos, pos, layout="full", **kw)  # build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gqa_decode_attention(q, kc, vc, slot_pos, pos, layout="full", **kw)
    for p in (40, 170, 299):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        want = decode_attention_torch(q.view(B, KV, H // KV, hd), kc, vc,
                                      slot_pos, pos, **kw).view(B, H, 1, hd)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------- seg_combine

def _seg_ids(rng, n, p, order):
    """Ids for ``order``: "sorted", "unsorted", "skewed" (half of the rows
    in 64 hot keys, unsorted, as the wordcount map emits them), or
    "dropped" and "dropped_unsorted" (ids < 0 and >= P among them, sorted
    or not)."""
    if order == "dropped":
        return np.sort(rng.integers(-3, p + 3, n))
    if order == "dropped_unsorted":
        return rng.integers(-3, p + 3, n)
    ids = rng.integers(0, p, n)
    if order == "skewed":
        ids = np.where(rng.random(n) < 0.5, rng.integers(0, 64, n), ids)
    return np.sort(ids) if order == "sorted" else ids


# (N, D, P) on each route: bins, global (P past the shared-memory bins),
# columns; N off the 8-row vector width
SEG_SHAPES = [(50_001, 1, 700), (50_001, 1, 20_000), (3_001, 5, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["sorted", "unsorted", "skewed", "dropped",
                                   "dropped_unsorted"])
@pytest.mark.parametrize("n,d,p", SEG_SHAPES)
def test_seg_combine_matches_plain_on_the_card(cuda_device, n, d, p, order, dtype):
    rng = np.random.default_rng(n + d + p)
    ids = torch.from_numpy(_seg_ids(rng, n, p, order).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dtype)
    kind = route(n, d, p)
    before = (seg_combine.launches, seg_combine.launches_by_variant[kind])
    got = seg_combine(vals.to(cuda_device), ids.to(cuda_device), p)
    torch.cuda.synchronize()
    assert (seg_combine.launches, seg_combine.launches_by_variant[kind]) == \
        (before[0] + 1, before[1] + 1)
    want = seg_combine_torch(vals, ids, p)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got.cpu(), reduce_plan(vals, ids, p).out,
                               rtol=1e-4, atol=1e-3)
    ones = torch.ones((n, d), dtype=dtype)
    counts = seg_combine(ones.to(cuda_device), ids.to(cuda_device), p)
    assert torch.equal(counts.cpu(), seg_combine_torch(ones, ids, p))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,p", SEG_SHAPES)
def test_seg_combine_on_misaligned_views(cuda_device, n, d, p):
    # values and ids that start 4 bytes past a 16-byte boundary take the
    # kernel's scalar loads
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(_seg_ids(rng, n, p, "skewed").astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    v = torch.empty(n * d + 1, device=cuda_device)[1:].view(n, d).copy_(vals)
    i = torch.empty(n + 1, dtype=torch.int32, device=cuda_device)[1:].copy_(ids)
    assert v.data_ptr() % 16 and i.data_ptr() % 16
    got = seg_combine(v, i, p)
    torch.testing.assert_close(got.cpu(), seg_combine_torch(vals, ids, p),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_seg_combine_captured_in_a_graph_replays(cuda_device):
    # the memset and the kernel are both captured: each replay starts from
    # zeros and sums the ids written in place before it
    rng = np.random.default_rng(3)
    n, p = 262_144, 4_128
    ids = torch.empty(n, dtype=torch.int32, device=cuda_device)
    vals = torch.ones((n, 1), device=cuda_device)
    ids.copy_(torch.from_numpy(np.sort(rng.integers(0, p, n)).astype(np.int32)))
    seg_combine(vals, ids, p)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = seg_combine(vals, ids, p)
    for order in ("sorted", "skewed", "dropped"):
        host = torch.from_numpy(_seg_ids(rng, n, p, order).astype(np.int32))
        ids.copy_(host)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), seg_combine_torch(vals.cpu(), host, p))


# ------------------------------------------------------------ fixture_copy

@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile,offset,path", [
    ((64, 4096), (16, 512), 0, "vector"),
    ((4, 1000), (1, 300), 0, "vector"),
    ((333, 1001), (8, 100), 0, "scalar"),      # C off the vector width
    ((64, 1024), (3, 30), 0, "scalar"),        # tile_c off the vector width
    ((64, 1024), (16, 512), 1, "scalar"),      # x 4 bytes past a boundary
])
def test_fixture_copy_paths_on_the_card(cuda_device, shape, tile, offset, path):
    rng = np.random.default_rng(4)
    host = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    x = torch.empty(host.numel() + offset, device=cuda_device)[offset:]
    x = x.view(shape).copy_(host)
    out = torch.empty_like(x)
    assert copy_route(*shape, tile, x.data_ptr(), out.data_ptr()) == path
    before = fixture_copy.launches_by_variant[path]
    assert fixture_copy(x, tile, out=out) is out
    torch.cuda.synchronize()
    assert fixture_copy.launches_by_variant[path] == before + 1
    assert torch.equal(out.cpu(), host)


@pytest.mark.cuda
def test_fixture_copy_faulty_grid_leaves_400_nan_on_the_card(cuda_device):
    from repro_torch.analysis.fixtures import bad_launch_probes, confirm_unwritten

    assert confirm_unwritten(bad_launch_probes()[0], cuda_device) == 400


# ------------------------------------------------- calibration, shuffle

@pytest.mark.cuda
def test_one_calibration_step_on_the_card_equals_the_cpu_step(cuda_device):
    # the loss, its gradient and one AdamW step through the job model in
    # float64, on the card against the CPU, at rtol 1e-9
    from repro_torch.calib import COST_FACTOR_NAMES, Observation
    from repro_torch.calib.fit import _stack_configs, build_loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.spec import JobSpec, hadoop_space

    base = JobSpec().replace(pNumNodes=8, pNumMappers=64, pNumReducers=16)
    obs = [Observation(spec=base.replace(pSortMB=mb), cost=cost)
           for mb, cost in ((32.0, 300.0), (64.0, 280.0), (128.0, 260.0))]
    names = list(COST_FACTOR_NAMES)
    space = hadoop_space()
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=10,
                      weight_decay=0.0, grad_clip_norm=10.0)
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        cols = _stack_configs(obs, dtype=torch.float64, device=dev)
        y = torch.tensor([o.cost for o in obs], dtype=torch.float64, device=dev)
        loss_fn = build_loss_fn(cols, names, y, torch.ones_like(y))
        u = {n: torch.tensor(float(space[n].relax(obs[0].spec[n])),
                             dtype=torch.float64, device=dev, requires_grad=True)
             for n in names}
        loss = loss_fn(u)
        grads = dict(zip(names, torch.autograd.grad(loss, [u[n] for n in names])))
        plain = {n: v.detach() for n, v in u.items()}
        new_u, _, _ = adamw_update(grads, adamw_init(plain), plain, cfg)
        results.append((float(loss.detach()), [float(grads[n]) for n in names],
                        [float(new_u[n]) for n in names]))
    (l_cpu, g_cpu, u_cpu), (l_gpu, g_gpu, u_gpu) = results
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-9)
    np.testing.assert_allclose(g_gpu, g_cpu, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(u_gpu, u_cpu, rtol=1e-9)


@pytest.mark.cuda
def test_nccl_pipeline_combines_into_shared_bins(cuda_device):
    # one NCCL rank: the shuffle's collective really runs; the combine of
    # one 128 MiB split's words (unsorted, P 8,192) takes the bins route and
    # sends all but a few of its passes into shared-memory bins
    import torch.distributed as dist

    from repro_torch.mapreduce import JOBS, make_input, make_pipeline, wordcount_map

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda_device)
    try:
        keys, values = make_input(JOBS["wordcount"], 335_544)
        keys = keys.astype(np.int32)
        before = dict(seg_combine.launches_by_variant)
        got = make_pipeline(key_space=8192)(keys, values)
        plain = make_pipeline(key_space=8192, use_kernel=False)(keys, values)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    after = seg_combine.launches_by_variant
    assert after["bins"] == before["bins"] + 1
    assert {k: after[k] - before[k] for k in after if k != "bins"} == \
        {k: 0 for k in after if k != "bins"}
    torch.testing.assert_close(got.cpu(), plain.cpu(), rtol=1e-5, atol=0)
    words, ones = wordcount_map(torch.from_numpy(keys), torch.from_numpy(values),
                                key_space=8192)
    plan = reduce_plan(ones[:, None], words, 8192)
    assert plan.route == "bins" and plan.passes - plan.bins_passes <= 2


def _wave_batch(b=16, n_jobs=8, seed=0):
    """A planner-shaped wave batch (fleet mix, all four policies)."""
    from repro_torch.cluster import default_job_classes, pack_trace, poisson_trace

    rng = np.random.default_rng(seed)
    cols = pack_trace(poisson_trace(default_job_classes(), n_jobs, rate=1.0,
                                    seed=3))
    nodes = rng.choice([2.0, 4.0, 8.0], b)
    fast = np.minimum(rng.choice([0.0, 2.0], b), nodes)
    rate = rng.choice([0.05, 0.2], b)
    tile = lambda a: np.tile(a, (b, 1))
    return {
        "arrival": tile(cols["arrival"]) / rate[:, None],
        "n_maps": tile(cols["n_maps"]), "n_reds": tile(cols["n_reds"]),
        "map_cost": tile(cols["map_cost"]), "red_work": tile(cols["red_work"]),
        "shuffle": tile(cols["shuffle"]) * ((nodes - 1) / nodes)[:, None],
        "queue": tile(cols["queue"]),
        "policy": rng.choice([0.0, 1.0, 2.0, 3.0], b),
        "slowstart": rng.choice([0.05, 0.8], b),
        "map_slots": np.stack([fast * 2, (nodes - fast) * 2], 1),
        "red_slots": np.stack([fast * 2, (nodes - fast) * 2], 1),
        "speedup": np.stack([np.where(fast > 0, 2.0, 1.0), np.ones(b)], 1),
    }


@pytest.mark.cuda
def test_wave_rollout_on_the_card_equals_the_cpu(cuda_device):
    # float64 on both; the card's elementwise ops and per-row reductions
    # round as the CPU's do, up to summation order
    from repro_torch.cluster import simulate_batch

    scen = _wave_batch()
    card = simulate_batch(scen, devices=[cuda_device])
    host = simulate_batch(scen, device="cpu")
    for k, v in host.items():
        assert card[k].dtype == v.dtype, k
        np.testing.assert_allclose(card[k], v, rtol=1e-9, err_msg=k)
    assert card["converged"].all()


@pytest.mark.cuda
def test_split_rows_over_the_same_card_twice(cuda_device):
    from repro_torch.cluster import simulate_batch
    from repro_torch.compat import split_rows

    scen = _wave_batch(b=9, seed=1)
    one = simulate_batch(scen, devices=[cuda_device])
    two = simulate_batch(scen, devices=[cuda_device, cuda_device])
    for k, v in one.items():
        assert two[k].tobytes() == v.tobytes(), k
    x = torch.arange(7.0, device=cuda_device)
    out = split_rows(lambda blk, dev: {"y": blk["x"] * 2},
                     {"x": x}, [cuda_device, cuda_device])
    assert out["y"].device == cuda_device
    torch.testing.assert_close(out["y"], x * 2, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "hd,H,KV,S,dtype",
    [(64, 4, 4, 100, torch.float32), (64, 18, 2, 100, torch.float32),
     (128, 4, 4, 100, torch.float32), (128, 18, 2, 100, torch.float32),
     (64, 4, 4, 1100, torch.float32), (64, 18, 2, 1100, torch.float32),
     (64, 4, 4, 1100, torch.bfloat16), (64, 18, 2, 1100, torch.bfloat16)],
    ids=["hd64-G1", "hd64-G9", "hd128-G1", "hd128-G9", "hd64-G1-S1100",
         "hd64-G9-S1100", "hd64-G1-S1100-bf16", "hd64-G9-S1100-bf16"])
def test_flash_gradients_on_the_card_equal_the_plain_version(cuda_device, hd, H,
                                                              KV, S, dtype):
    # the kernel forward under autograd, the backward in plain PyTorch in
    # blocks of query rows (five blocks of up to 256 at S 1,100), with no
    # flash launch, against autograd through the plain version; bf16
    # gradients are the fp32 ones rounded once, so within a bf16 step
    from repro_torch.kernels.flash_attention import flash_attention_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    q0, k0, v0 = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                  .to(cuda_device, dtype)
                  for s in ((2, H, S, hd), (2, KV, S, hd), (2, KV, S, hd)))
    dout = torch.from_numpy(rng.standard_normal((2, H, S, hd), dtype=np.float32)
                            ).to(cuda_device, dtype)
    grads = {}
    for name, fn in (("kernel", flash_attention), ("plain", flash_attention_torch)):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        before = flash_attention.launches
        out = fn(q, k, v, causal=True)
        assert flash_attention.launches == before + (name == "kernel")
        grads[name] = (out, *torch.autograd.grad(out, (q, k, v), dout))
        assert flash_attention.launches == before + (name == "kernel")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert got.dtype == want.dtype == dtype
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_decode_at_nine_heads_per_group_without_softcap(cuda_device, dtype, tol):
    # starcoder2-7b's geometry: 36 heads over 4 kv heads, hd 128, no softcap
    q, kc, vc, slot_pos = _decode_inputs(cuda_device, dtype, B=4, H=36, KV=4,
                                         S=1024, hd=128, seed=12)
    for p in (0, 527, 1023):
        pos = torch.tensor(p, dtype=torch.int32, device=cuda_device)
        before = gqa_decode_attention.launches
        got = gqa_decode_attention(q, kc, vc, slot_pos, pos, layout="full")
        assert gqa_decode_attention.launches == before + 1
        want = decode_attention_torch(q.view(4, 4, 9, 128), kc, vc, slot_pos, pos)
        torch.testing.assert_close(got.float(), want.view(4, 36, 1, 128).float(),
                                   rtol=tol, atol=tol)


# ------------------------------------------------- slice 5b's geometries

# (B, H, KV, Sq, Sk, hd, causal, window): recurrentgemma-9b's local prefill
# (G 16, hd 256, window 2,048) and a prompt that wraps its window;
# seamless-m4t-large-v2's encoder and cross-attention (non-causal, Sq != Sk)
FAMILY_FLASH = [(4, 16, 1, 512, 512, 256, True, 2048),
                (1, 16, 1, 2100, 2100, 256, True, 2048),
                (4, 16, 16, 1024, 1024, 64, False, None),
                (4, 16, 16, 256, 1024, 64, False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FAMILY_FLASH,
                         ids=["rg-local", "rg-wrapped", "enc", "cross"])
def test_flash_at_slice_5b_geometries(cuda_device, shape, dtype, tol):
    from repro_torch.kernels.flash_attention import flash_attention_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, KV, Sq, Sk, hd, causal, window = shape
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, H, KV, S, hd, pos, window, ring): recurrentgemma-9b's serving step on a
# ring of 1,024, its wrapped ring of 2,048 at pos 2,100, and seamless's cross
# decode over a static cache at pos = S (every slot seen)
FAMILY_DECODE = [(4, 16, 1, 1024, 256, 527, 2048, True),
                 (1, 16, 1, 2048, 256, 2100, 2048, True),
                 (4, 16, 16, 1024, 64, 1024, None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FAMILY_DECODE, ids=["rg-ring", "rg-wrapped", "cross"])
def test_decode_at_slice_5b_geometries(cuda_device, shape, dtype, tol):
    B, H, KV, S, hd, p, window, ring = shape
    q, kc, vc, slot_pos = _decode_inputs(cuda_device, dtype, B=B, H=H, KV=KV, S=S,
                                         hd=hd, seed=21)
    pos = torch.tensor(p, dtype=torch.int32, device=cuda_device)
    if ring:
        slot_pos = pos - torch.remainder(pos - slot_pos, S)
    before = gqa_decode_attention.launches
    got = gqa_decode_attention(q, kc, vc, slot_pos, pos, window=window,
                               layout="ring" if ring else "full")
    assert gqa_decode_attention.launches == before + 1
    want = decode_attention_torch(q.view(B, KV, H // KV, hd), kc, vc, slot_pos, pos,
                                  window=window)
    torch.testing.assert_close(got.float(), want.view(B, H, 1, hd).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-130m", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_graphed_decode_steps_equal_eager_ones_per_family(cuda_device, name):
    # each family's smoke config in bf16 on the card: prefill, then greedy
    # decode steps eagerly and replayed as a CUDA graph (MoE routing, the
    # recurrent states written in place, the cross cache's pos kept from
    # prefill), the same tokens and the same last logits
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_params
    from repro_torch.runtime.decode_graph import GreedyDecoder

    cfg = get_config(name).smoke().replace(dtype="bfloat16")
    model = init_params(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                        device=cuda_device)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2, 24)), device=cuda_device)
    src = None
    if cfg.is_encdec:
        src = torch.randn((2, 40, cfg.d_model), device=cuda_device).to(torch.bfloat16)
    runs = []
    for graphed in (False, True):
        if src is None:
            logits, caches, pos = model.prefill(toks, 64)
        else:
            logits, caches, pos = model.prefill(src, toks, 64)
        dec = GreedyDecoder(model, caches, torch.argmax(logits[:, -1:], dim=-1), pos,
                            cuda_graph=graphed)
        out = torch.cat([dec.step().clone() for _ in range(5)], dim=1)
        torch.cuda.synchronize()
        runs.append((out, dec.logits.float().clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_profiled_batches_capture_once_each_and_a_collection_in_capture_changes_nothing(
        cuda_device, monkeypatch):
    # deepseek-moe-16b's smoke config in bf16 served by throughput_batch under
    # torch.profiler: one decoder.capture range and one graph capture counted
    # a batch; a collection forced inside the capture (a gc.collect range
    # opened while the stream captures) leaves the served tokens as they were
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_params
    from repro_torch.runtime.decode_graph import GreedyDecoder
    from repro_torch.runtime.serve_loop import Server

    cfg = get_config("deepseek-moe-16b").smoke().replace(dtype="bfloat16")
    model = init_params(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                        device=cuda_device)
    prompts = np.random.default_rng(4).integers(2, cfg.vocab_size, (2, 24))
    server = Server(cfg, model, max_len=40, device=cuda_device)
    eager = server.throughput_batch(prompts, 8, cuda_graph=False)["output"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        plain = [server.throughput_batch(prompts, 8)["output"] for _ in range(2)]
    host = [e for e in prof.events() if e.device_type.name == "CPU"]
    assert len([e for e in host if e.name == "decoder.capture"]) == 2
    assert server.metrics.counter("server.graph_captures").value == 2

    run, collected = GreedyDecoder._run, []

    def run_and_collect(self):
        if torch.cuda.is_current_stream_capturing():
            collected.append(gc.collect())
        return run(self)

    monkeypatch.setattr(GreedyDecoder, "_run", run_and_collect)
    with profile(activities=acts) as prof:
        forced = server.throughput_batch(prompts, 8)["output"]
    assert len(collected) == 1
    assert [e for e in prof.events() if e.name == "gc.collect" and e.device_type.name == "CPU"]
    np.testing.assert_array_equal(forced, plain[0])
    np.testing.assert_array_equal(plain[1], plain[0])
    np.testing.assert_array_equal(plain[0], eager)


@pytest.mark.cuda
def test_checkpoint_bf16_round_trip_from_cuda_tensors(cuda_device, tmp_path):
    # an async save copies to the host before it returns: the in-place
    # update right after it does not reach the files
    from repro_torch.checkpoint import CheckpointManager

    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn((64, 96), generator=g, device=cuda_device).to(torch.bfloat16),
            "m": torch.randn((5, 7), generator=g, device=cuda_device),
            "count": torch.tensor(3, dtype=torch.int32, device=cuda_device)}
    want = {k: v.clone() for k, v in tree.items()}
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, tree, blocking=False)
    tree["w"].add_(1.0)
    cm.wait()
    got, manifest = cm.restore(want)
    assert manifest["step"] == 2
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        assert torch.equal(got[k], v.cpu()), k


@pytest.mark.cuda
def test_trainer_crash_and_resume_bit_for_bit_on_the_card(cuda_device, tmp_path,
                                                          monkeypatch):
    # two layers of stablelm-1.6b's smoke config in bf16 (the flash kernel
    # on wgmma), under deterministic algorithms: 4 steps uninterrupted
    # against a crash at step 2 after a save at step 1, resumed to 4
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config("stablelm-1.6b").smoke().replace(dtype="bfloat16", n_layers=2)

    def tcfg(d, **kw):
        return TrainerConfig(global_batch=4, seq_len=128, n_microbatches=2,
                             ckpt_dir=str(tmp_path / d), ckpt_every=2, log_every=1,
                             opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                             total_steps=8), **kw)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        before = flash_attention.launches_by_variant.get("bf16_wgmma", 0)
        ref = Trainer(cfg, tcfg("a")).run(4, resume=False)
        assert flash_attention.launches_by_variant["bf16_wgmma"] - before == 4 * 2 * 2 * 2
        with pytest.raises(RuntimeError, match="injected failure at step 2"):
            Trainer(cfg, tcfg("b", fail_at_step=2)).run(4, resume=False)
        resumed = Trainer(cfg, tcfg("b")).run(4, resume=True)
    finally:
        torch.use_deterministic_algorithms(was)
    assert ref["final_loss"] == resumed["final_loss"]
    for k, p in ref["params"].items():
        assert p.device.type == "cuda"
        assert torch.equal(p, resumed["params"][k]), k
    for part in ("m", "v"):
        for k, t in ref["opt"][part].items():
            assert torch.equal(t, resumed["opt"][part][k]), (part, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("gemma2-9b", "float32"), ("gemma2-9b", "bfloat16"),
                                        ("seamless-m4t-large-v2", "bfloat16")])
def test_step_factories_through_the_kernels_on_the_card(cuda_device, name, dtype):
    # make_prefill_step and 3 make_decode_step steps on a smoke config: one
    # flash launch per attention layer, one decode launch per attention
    # layer and step, and the logits of prefill / decode_step called directly
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_params, make_decode_step, make_prefill_step

    cfg = get_config(name).smoke().replace(dtype=dtype)
    model = init_params(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                        device=cuda_device)
    rng = np.random.default_rng(8)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2, 24)), device=cuda_device)
    batch = {"inputs": toks}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.randn((2, 40, cfg.d_model), device=cuda_device,
                                          dtype=getattr(torch, dtype))
        n_flash, n_decode = cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    else:
        n_flash = n_decode = sum(layer.mixer in ("attn", "local") for layer in model.layers)
    prefill, decode_step = make_prefill_step(cfg, 64), make_decode_step(cfg)
    f0, d0 = flash_attention.launches, gqa_decode_attention.launches
    out = prefill(model, batch)
    got, caches, pos = [out["logits"]], out["caches"], out["pos"]
    for _ in range(3):
        tok = torch.argmax(got[-1][:, -1:], dim=-1)
        step = decode_step(model, {"token": tok, "caches": caches, "pos": pos})
        got.append(step["logits"])
        caches, pos = step["caches"], pos + 1
    torch.cuda.synchronize()
    assert flash_attention.launches - f0 == n_flash
    assert gqa_decode_attention.launches - d0 == n_decode * 3
    if cfg.is_encdec:
        first, caches, pos = model.prefill(batch["src_embeds"], toks, 64)
    else:
        first, caches, pos = model.prefill(toks, 64)
    want = [first]
    for _ in range(3):
        nxt, caches = model.decode_step(torch.argmax(want[-1][:, -1:], dim=-1), caches, pos)
        want.append(nxt)
        pos = pos + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,lse_tol", [(torch.float32, 1e-5, 1e-5),
                                               (torch.bfloat16, 2e-2, 1e-3)])
@pytest.mark.parametrize("first", [0, 512])
def test_decode_lse_at_a_split_span_on_the_card(cuda_device, dtype, tol, lse_tol, first):
    """A rank's span of a ring of 1,024 split over two ranks, as
    recurrentgemma-9b serves it at tp 2 (B 4, 16 q heads over its one kv
    head, hd 256, window 2,048, pos 527), read whole (layout None): rank 0's
    span has all 512 slots live, rank 1's 16, and a span past pos none.
    The kernel's output and lse equal the plain version's; asking for the
    lse leaves the output bit for bit."""
    B, H, KV, S, hd, pos = 4, 16, 1, 512, 256, 527
    q, kc, vc, _ = _decode_inputs(cuda_device, dtype, B=B, H=H, KV=KV, S=S, hd=hd, seed=25)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    i = torch.arange(2 * S, dtype=torch.int32, device=cuda_device)
    ring = p - torch.remainder(p - i, 2 * S)
    for sp in (ring[first:first + S].contiguous(),
               torch.full((S,), -1, dtype=torch.int32, device=cuda_device)):
        kw = dict(window=2048, logit_cap=None)
        out, lse = gqa_decode_attention(q, kc, vc, sp, p, return_lse=True, **kw)
        assert torch.equal(out, gqa_decode_attention(q, kc, vc, sp, p, **kw))
        want, want_lse = decode_attention_torch(q.view(B, KV, H // KV, hd), kc, vc, sp, p,
                                                return_lse=True, **kw)
        torch.testing.assert_close(out.float(), want.view(B, H, 1, hd).float(),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(lse, want_lse.view(B, H, 1), rtol=0.0, atol=lse_tol)
    # the last span sees no slot: -inf and a zero output
    assert torch.equal(lse, torch.full_like(lse, -torch.inf))
    assert torch.equal(out, torch.zeros_like(out))
