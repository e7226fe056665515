"""The latent-attention cell at a tiny size on the CPU: the harness runs
``deepseek-v2-lite.doc-qa`` cut to a few narrow layers through the
program's sessions and holds it to the plain reference; the faults an MLA
port can have come out incorrect; the files it adds to the benchmark are
well formed."""

import json

import pytest
import torch

from perfbench import calibrate, harness, mla_arith, mla_weights, tiny
from perfbench.harness import ROOT, Context

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "deepseek-v2-lite.doc-qa"

#: the source's keys at tiny widths (every kind of layer kept: the dense
#: first layer, then MoE layers)
TINY_MLA = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                vocab_size=256, num_hidden_layers=3, intermediate_size=128,
                moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
                n_shared_experts=1, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, dtype="float32")


def write(tmp) -> harness.Layout:
    """The tiny cells of :mod:`perfbench.tiny` and ``tiny.doc-qa`` under
    ``tmp``, listed where ``deepseek-v2-lite.doc-qa`` is."""
    layout = tiny.write(tmp)
    pb = tmp / "perfbench"
    cfg = {**json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json").read_text()),
           **TINY_MLA}
    wl = json.loads((ROOT / f"perfbench/workloads/{CELL}.json").read_text())
    wl["config"] = "tiny-mla"
    wl["traffic"].update(rows=4, documents=2, doc_tokens=12, question_tokens=3,
                         answer_tokens=5, check_batches=2, check_rows=2)
    wl["limits"] = {"logit_gap_mean": tiny.TINY_LIMITS["logit_gap_mean"]}
    (pb / "configs/tiny-mla.json").write_text(json.dumps(cfg))
    (pb / "workloads/tiny.doc-qa.json").write_text(json.dumps(wl))
    bench = layout.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.doc-qa")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return layout


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return write(tmp_path_factory.mktemp("tiny_mla"))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_doc_qa_run_is_correct(layout, trace):
    result = tiny.run_cell(layout, "tiny.doc-qa", trace=trace)
    assert result["correct"] is True and result["attempted"] >= 1, result["checks"]
    assert result["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(layout.benchmark(), "tiny.doc-qa",
                                                    bool(trace))}
    assert set(result["metrics"]) <= want
    if trace:
        assert "session.decode_step_ms" in result["metrics"]
    else:
        assert {"setup_s", "serve_tokens_per_s"} <= set(result["metrics"])


def test_sound_runs_pass_and_the_control_fails(layout):
    wl = layout.json("workloads", "tiny.doc-qa")
    ctx = Context(workload=wl, config=layout.json("configs", wl["config"]),
                  seed=2**40 + 3, device=torch.device("cpu"))
    got = calibrate.serve_seed(layout.module("drivers", "serve_session"), ctx, True)
    limit = wl["limits"]["logit_gap_mean"]
    assert got["program"]["logit_gap_mean"] <= limit < got["control"]["logit_gap_mean"], got
    assert got["norms_ignored"]["logit_gap_mean"] > limit, got


def _no_m2(mla):
    return "softmax_scale", lambda cfg: (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def _rope_off_k_pe(mla):
    def latent(p, x, positions, inv_freq, cfg):
        R = cfg.kv_lora_rank
        kv = x @ p["kv_a"].to(x.dtype)
        c = mla.apply_norm(p["kv_norm"], kv[..., :R], "rmsnorm", cfg.norm_eps)
        return torch.cat([c, kv[..., R:]], dim=-1)
    return "_latent", latent


def _latent_norm_ignored(mla):
    def latent(p, x, positions, inv_freq, cfg):
        R = cfg.kv_lora_rank
        kv = x @ p["kv_a"].to(x.dtype)
        k_pe = mla.apply_rope(kv[..., R:], positions.reshape(1, -1), inv_freq)
        return torch.cat([kv[..., :R], k_pe], dim=-1)
    return "_latent", latent


def _stale_slot_past_pos(mla):
    plain = mla.mla_decode_torch

    def read_past(q, latent, pos, *, scale, v_dim):
        return plain(q, latent, pos + 1, scale=scale, v_dim=v_dim)
    return "mla_decode_torch", read_past


@pytest.mark.parametrize("fault", [_no_m2, _rope_off_k_pe, _latent_norm_ignored,
                                   _stale_slot_past_pos])
def test_mla_faults_come_out_incorrect(layout, monkeypatch, fault):
    from repro_torch.models import attention, mla

    # the CPU path of the kernel's wrapper is the plain twin: decode through it
    monkeypatch.setattr(attention, "_IMPL", "torch")
    name, planted = fault(mla)
    monkeypatch.setattr(mla, name, planted)
    assert tiny.run_cell(layout, "tiny.doc-qa")["correct"] is False


def test_the_benchmark_files_are_well_formed():
    cfg = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json").read_text())
    flat = mla_weights.flat(cfg)
    assert "no cut" in cfg["notes"]
    assert (flat["n_layers"], flat["n_experts"], flat["vocab_size"]) == (27, 64, 102400)
    port = mla_weights.port_config(cfg)
    assert port.attention == "mla" and port.head_dim == 192
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["config"] == "deepseek-v2-lite" and cells[CELL]["chips"] == 1
    wl = json.loads((ROOT / f"perfbench/workloads/{CELL}.json").read_text())["traffic"]
    assert wl["rows"] * (wl["question_tokens"] + wl["answer_tokens"]) == 8192
    assert wl["doc_tokens"] + wl["question_tokens"] + wl["answer_tokens"] == 8256
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["serve_tokens_per_s"]["workloads"]
    assert [m["name"] for m in BENCH["per_layer"] if CELL in m["workloads"]] == [
        "session.decode_step_ms", "session.mla_decode_share", "session.mla_decode_roofline",
        "session.device_idle"]


def test_the_latent_arithmetic():
    cfg = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json").read_text())
    assert mla_arith.latent_row_bytes(cfg) == 1152
    # 128 sessions x 27 layers x 8,256 positions: the cache the cell holds
    assert 128 * 27 * 8256 * mla_arith.latent_row_bytes(cfg) == pytest.approx(32.9e9, rel=2e-3)
    b = mla_arith.decode_bound(cfg, 1, 8256)
    assert b["by"] == "bytes" and b["bytes"] == 8256 * 1152 + 16 * (1024 + 64) * 2
