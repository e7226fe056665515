"""DeepSeek-V2's multi-head latent attention (MLA) in the port, at tiny
widths on the CPU: the model against the benchmark's plain reference
(``perfbench/reference/mla.py``) on seeded weights, the decode kernel's
plain twin against the non-absorbed formula, the YaRN frequencies and
softmax scale against their closed forms, the sessions of
``Server.open_batch`` and their turns, and their spans and counters.

The reference package has no MLA, so nothing here imports JAX."""

import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.kernels import mla_decode_attention, ops
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.kernels.mla_decode import (launch_spec, merge_plan, mla_decode_torch,
                                          split_plan)
from repro_torch.models import mla, weights
from repro_torch.models.config import refuse_mla
from repro_torch.obs import observe
from repro_torch.runtime import decode_graph
from repro_torch.runtime.serve_loop import Server

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import mla_weights  # noqa: E402
from perfbench.reference import lm as ref_lm  # noqa: E402
from perfbench.reference import mla as ref_mla  # noqa: E402

CFG = get_config("deepseek-v2-lite").smoke()

#: the smoke config in the benchmark's flat keys, for the reference
FLAT = dict(n_layers=CFG.n_layers, d_model=CFG.d_model, n_heads=CFG.n_heads,
            n_kv_heads=CFG.n_kv_heads, head_dim=CFG.head_dim, d_ff=CFG.d_ff,
            vocab_size=CFG.vocab_size, mlp_type="swiglu", norm_type="rmsnorm",
            norm_eps=CFG.norm_eps, rope_fraction=1.0, rope_theta=CFG.rope_theta,
            n_experts=CFG.n_experts, n_shared_experts=CFG.n_shared_experts,
            moe_top_k=CFG.moe_top_k, d_expert=CFG.d_expert,
            moe_layer_start=CFG.moe_layer_start, d_ff_dense=CFG.d_ff_dense,
            kv_lora_rank=CFG.kv_lora_rank, qk_nope_head_dim=CFG.qk_nope_head_dim,
            qk_rope_head_dim=CFG.qk_rope_head_dim, v_head_dim=CFG.v_head_dim,
            rope_scaling_factor=CFG.rope_scaling_factor,
            rope_original_max_position=CFG.rope_original_max_position,
            rope_beta_fast=CFG.rope_beta_fast, rope_beta_slow=CFG.rope_beta_slow,
            rope_mscale=CFG.rope_mscale, rope_mscale_all_dim=CFG.rope_mscale_all_dim)


def _model(seed: int = 3):
    w = mla_weights.make(FLAT, seed, torch.float32, "cpu")
    model = weights.empty(CFG, device="cpu", param_dtype=torch.float32)
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(w)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(w[name])
    return model, w


def _tokens(shape, seed: int = 0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CFG.vocab_size, shape))


def test_the_architecture_is_the_ports_own():
    assert "deepseek-v2-lite" not in ARCHS and "deepseek-v2-lite" in PORT_ARCHS
    cfg = get_config("deepseek-v2-lite")
    assert (cfg.n_layers, cfg.n_experts, cfg.vocab_size, cfg.kv_lora_rank) == (27, 64,
                                                                             102400, 512)
    assert get_config("deepseek-moe-16b").attention == "gqa"
    with pytest.raises(NotImplementedError, match="MLA"):
        refuse_mla(cfg, "the Trainer")


def test_yarn_frequencies_and_scale_match_their_closed_forms():
    cfg = get_config("deepseek-v2-lite")
    inv = mla.yarn_frequencies(cfg).double()
    dim, theta, factor = 64, 10000.0, 40.0
    plain = theta ** (-np.arange(0, dim, 2) / dim)

    def corr(turns):
        return dim * math.log(4096 / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    for i in range(dim // 2):
        r = min(max((i - low) / (high - low), 0.0), 1.0)
        assert inv[i].item() == pytest.approx(plain[i] * (1 - r) + plain[i] / factor * r,
                                              rel=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert mla.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    source = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json").read_text())
    flat = mla_weights.flat(source)
    torch.testing.assert_close(ref_mla.yarn_frequencies(flat), inv.float(), rtol=1e-6,
                               atol=0)
    assert ref_mla.softmax_scale(flat) == pytest.approx(mla.softmax_scale(cfg), rel=1e-12)


def test_the_plain_twin_matches_the_non_absorbed_attention():
    g = torch.Generator().manual_seed(1)
    B, H, S, R, dr, dn, dv = 2, 4, 20, 32, 8, 16, 16
    c = torch.randn(B, S, R, generator=g)
    k_pe = torch.randn(B, S, dr, generator=g)
    w_uk = torch.randn(R, H, dn, generator=g) * R ** -0.5       # fan-in scaled
    w_uv = torch.randn(R, H, dv, generator=g) * R ** -0.5
    q_nope, q_pe = torch.randn(B, H, dn, generator=g), torch.randn(B, H, dr, generator=g)
    pos = torch.tensor(13, dtype=torch.int32)
    scale = 0.3
    # non-absorbed: k_nope, v per head, scores over slots 0 .. pos
    k_nope = torch.einsum("bsr,rhn->bhsn", c, w_uk)
    v = torch.einsum("bsr,rhv->bhsv", c, w_uv)
    s = (torch.einsum("bhn,bhsn->bhs", q_nope, k_nope)
         + torch.einsum("bhd,bsd->bhs", q_pe, k_pe)) * scale
    s[..., 14:] = -torch.inf
    want = torch.einsum("bhs,bhsv->bhv", torch.softmax(s, -1), v)
    qa = torch.cat([torch.einsum("bhn,rhn->bhr", q_nope, w_uk), q_pe], -1)
    lat = torch.cat([c, k_pe], -1)
    o_lat = mla_decode_torch(qa, lat, pos, scale=scale, v_dim=R)
    torch.testing.assert_close(torch.einsum("bhr,rhv->bhv", o_lat, w_uv), want,
                               rtol=1e-5, atol=1e-5)
    before = mla_decode_attention.launches
    torch.testing.assert_close(mla_decode_attention(qa, lat, pos, scale=scale, v_dim=R),
                               o_lat, rtol=0, atol=0)
    assert mla_decode_attention.launches == before      # the CPU takes the twin


@pytest.mark.parametrize("pos,S,n", [(0, 8256, 2), (8255, 8256, 2), (100, 8256, 32),
                                     (40, 33, 32)])
def test_the_split_covers_the_live_span_once(pos, S, n):
    # one batch row: the CTAs' segments, in CTA order, are its live slots
    plan = split_plan(pos, 1, S, n)
    flat = [s for segs in plan for b, first, end in segs for s in range(first, end)]
    assert flat == list(range(min(pos, S - 1) + 1))
    assert all(b == 0 for segs in plan for b, _, _ in segs)


def test_the_launch_is_one_cta_a_sm_with_its_ring_in_shared_memory():
    spec = launch_spec(128, 8256, 576)
    assert spec.grid == (mla_kernel.SMS, 1, 1) and spec.block == (160, 1, 1)
    # the ring fills a block's shared memory, so a SM holds one CTA
    assert 233_472 // 2 - 1024 < spec.smem_bytes <= 232_448
    n_stages, stage = mla_kernel.stages(576), 9 * 32 * 64 * 2   # 9 TMA boxes a stage
    assert n_stages == 6 and spec.smem_bytes == n_stages * stage + mla_kernel.FIXED_BYTES
    # one stage fewer where shared memory does not start on the swizzle's
    # 1,024-byte period, still well over the least
    assert (spec.smem_bytes - mla_kernel.FIXED_BYTES - 1008) // stage == 5 > mla_kernel.MIN_STAGES
    # the tiles in flight while one is reduced: at least 128 KB of rows
    assert (n_stages - 1) * 32 * 576 * 2 >= 128 * 1024
    assert launch_spec(4, 8256, 576).grid[0] == 128       # 32 CTAs a batch row
    assert launch_spec(1, 40, 576).grid[0] == 2           # one a tile at most


@pytest.mark.parametrize("pos", [0, 31, 32, 8255, 9000])
@pytest.mark.parametrize("B", [1, 4, 128, 200])
def test_the_balanced_split_reads_every_live_slot_once(B, pos):
    S = 8256
    n_ctas = launch_spec(B, S, 576).grid[0]
    n = min(pos, S - 1) + 1
    plan = split_plan(pos, B, S, n_ctas)
    assert len(plan) == n_ctas
    seen = np.zeros((B, S), dtype=np.int64)
    tiles = []
    for segs in plan:
        for b, first, end in segs:
            assert first % 32 == 0 and first < end <= n
            seen[b, first:end] += 1
        tiles.append(sum(-(-(end - first) // 32) for _, first, end in segs))
    assert (seen[:, :n] == 1).all() and (seen[:, n:] == 0).all()
    # the flattened (row, tile) work is split evenly: no CTA takes more than
    # one tile above the mean
    assert sum(tiles) == B * -(-n // 32)
    assert max(tiles) <= sum(tiles) / n_ctas + 1
    # CTA c's segment of row b writes partial slot b + c; each row merges its
    # segments' slots in CTA order, the range merge_plan gives (cta_of in the
    # source), at most 33 of them; no two segments share a slot
    merges = merge_plan(pos, B, S, n_ctas)
    slots = [[] for _ in range(B)]
    for c, segs in enumerate(plan):
        for b, _, _ in segs:
            slots[b].append(b + c)
    assert [list(r) for r in merges] == slots
    assert max(len(r) for r in merges) <= mla_kernel.MAX_SPLITS + 1
    every = [s for r in merges for s in r]
    assert len(set(every)) == len(every) and max(every) < B + n_ctas


@pytest.mark.parametrize("B,H,S,pos,n_ctas", [(3, 4, 100, 99, 7), (3, 4, 100, 40, 7),
                                              (2, 3, 70, 500, 16), (5, 2, 64, 0, 9),
                                              (1, 4, 96, 95, 2)])
def test_merging_the_segments_partials_gives_the_plain_twin(B, H, S, pos, n_ctas):
    # the kernel's arithmetic in fp32 on the CPU: each CTA's segments reduced
    # tile by tile with an online softmax into (m, l, acc) at slot b + c,
    # then each row's slots merged in merge_plan's order
    D, V, scale = 24, 16, 0.3
    g = torch.Generator().manual_seed(B * 100 + pos)
    q, lat = torch.randn(B, H, D, generator=g), torch.randn(B, S, D, generator=g)
    part = {}
    for c, segs in enumerate(split_plan(pos, B, S, n_ctas)):
        for b, first, end in segs:
            m, l, acc = torch.full((H,), -1e30), torch.zeros(H), torch.zeros(H, V)
            for j in range(first, end, 32):
                rows = lat[b, j:min(end, j + 32)]
                s = (q[b] @ rows.T) * scale
                m_new = torch.maximum(m, s.amax(-1))
                corr, p = torch.exp(m - m_new), torch.exp(s - m_new[:, None])
                l, acc, m = l * corr + p.sum(-1), acc * corr[:, None] + p @ rows[:, :V], m_new
            part[b + c] = (m, l, acc)
    got = torch.zeros(B, H, V)
    for b, slots in enumerate(merge_plan(pos, B, S, n_ctas)):
        if slots:
            M = torch.stack([part[i][0] for i in slots]).amax(0)
            L = sum(part[i][1] * torch.exp(part[i][0] - M) for i in slots)
            acc = sum(part[i][2] * torch.exp(part[i][0] - M)[:, None] for i in slots)
            got[b] = acc / L[:, None]
    want = mla_decode_torch(q, lat, torch.tensor(pos, dtype=torch.int32), scale=scale, v_dim=V)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_kernel_wrapper_is_replayed_by_the_decode_graph():
    assert ops.mla_decode_attention in ops.COUNTED_WRAPPERS
    before = mla_decode_attention.launches
    n = len(ops.COUNTED_WRAPPERS)
    deltas = [(0, {})] * (n - 1) + [(27, {})]
    decode_graph._add(deltas, +1)
    decode_graph._add(deltas, +1)
    assert mla_decode_attention.launches == before + 54
    decode_graph._add(deltas, -2)


@torch.no_grad()
def test_the_forward_and_decode_match_the_reference():
    model, w = _model()
    doc = _tokens((1, 10))[0]
    follows = _tokens((2, 5), seed=1)
    # the reference: the document (dropless at the smoke's capacity factor
    # 8), then each continuation over its latent rows
    want = ref_mla.chosen_logits(w, FLAT, doc, follows, 0, None, ref_lm.Precision())
    full = torch.cat([doc.expand(2, -1), follows], 1)
    logits, _, _ = model(full)
    torch.testing.assert_close(logits[:, 10:].flatten(0, 1), want, rtol=1e-4, atol=1e-4)
    # prefill of the document, then decode through the latent cache
    got = []
    for row in range(2):
        last, caches, pos = model.prefill(doc[None], 24)
        assert caches[0]["latent"].shape == (1, 24, CFG.kv_lora_rank + CFG.qk_rope_head_dim)
        for j in range(5):
            out, caches = model.decode_step(follows[row:row + 1, j:j + 1], caches, pos)
            pos = pos + 1
            got.append(out[0, -1])
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


@torch.no_grad()
def test_shared_prompts_open_as_unshared_prefills_bit_for_bit():
    model, _ = _model()
    docs = _tokens((2, 9), seed=2).numpy()
    prompts = docs[[0, 1, 1, 0, 1]]
    server = Server(CFG, model, max_len=20, device="cpu")
    session = server.open_batch(prompts, 8)
    assert server.metrics.counter("server.prefills").value == 2
    assert server.metrics.counter("server.prefix_rows_shared").value == 3 * 9
    for row in range(5):
        _, own, _ = model.prefill(torch.as_tensor(prompts[row:row + 1]), 20)
        for layer, mine in zip(session.decoder.caches, own):
            assert torch.equal(layer["latent"][row:row + 1], mine["latent"])


@torch.no_grad()
def test_a_rewound_turn_equals_a_fresh_prefill_of_document_and_question():
    model, _ = _model()
    docs = _tokens((2, 9), seed=4).numpy()
    prompts = docs[[0, 1, 0]]
    server = Server(CFG, model, max_len=20, device="cpu")
    session = server.open_batch(prompts, 8)
    session.turn(_tokens((3, 4), seed=5).numpy(), 4)         # an earlier turn
    questions = _tokens((3, 3), seed=6).numpy()
    got = session.turn(questions, 5)["output"]
    for row in range(3):
        seq = torch.as_tensor(np.concatenate([prompts[row], questions[row]])[None])
        logits, caches, pos = model.prefill(seq, 20)
        tok = logits[:, -1:].argmax(-1)
        want = [int(tok)]
        for _ in range(4):
            logits, caches = model.decode_step(tok, caches, pos)
            pos = pos + 1
            tok = logits[:, -1:].argmax(-1)
            want.append(int(tok))
        assert list(got[row]) == want


def _parents(events) -> dict:
    """The enclosing span of each B event's name (the first time it opens)."""
    stack, parent = [], {}
    for e in events:
        if e["ph"] == "B":
            parent.setdefault(e["name"], stack[-1] if stack else None)
            stack.append(e["name"])
        elif e["ph"] == "E":
            stack.pop()
    return parent


@torch.no_grad()
def test_spans_nest_and_the_latent_counter_has_its_closed_form():
    model, _ = _model()
    docs = _tokens((2, 9), seed=7).numpy()
    server = Server(CFG, model, max_len=20, device="cpu")
    with observe() as ob:
        session = server.open_batch(docs[[0, 1, 0, 1]], 8)
        out = session.turn(_tokens((4, 3), seed=8).numpy(), 5)
    parent = _parents(ob.tracer.events())
    assert parent["server.open"] is None and parent["server.turn"] is None
    assert parent["server.prefill"] == parent["server.share"] == "server.open"
    assert parent["attn.mla_prefill"] == "server.prefill"
    for name in ("server.rewind", "server.question", "server.decode"):
        assert parent[name] == "server.turn"
    names = [e["name"] for e in ob.tracer.events() if e["ph"] == "B"]
    assert names.count("server.prefill") == 2
    assert names.count("attn.mla_prefill") == 2 * CFG.n_layers
    steps = 3 + 5 - 1
    assert out["steps"] == steps
    slots = 4 * CFG.n_layers * sum(9 + j + 1 for j in range(steps))
    assert out["latent_slots_read"] == slots
    assert server.metrics.counter("mla.latent_slots_read").value == slots
    assert server.metrics.counter("server.turns").value == 1
