"""The benchmark's frozen arithmetic, pinned to the figures PERF.md keeps."""

import json

import pytest

from perfbench import arith
from perfbench.harness import ROOT


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def test_flash_bound_at_the_training_geometry():
    b = arith.flash_bound(4, 32, 32, 2048, 2048, 64, causal=True)
    assert b["flop"] == pytest.approx(6.875e10, rel=1e-4)
    assert b["seconds"] * 1e3 == pytest.approx(0.0695, abs=5e-5)
    assert b["by"] == "operations"


def test_decode_bound_at_gemma2_9b_main_shape():
    # B 4, H 16, KV 8, S 1,024, hd 256, pos 1,023: every slot live
    b = arith.decode_bound(4, 16, 8, 256, 1024)
    assert b["bytes"] / 1e6 == pytest.approx(33.6, abs=0.05)
    assert b["seconds"] * 1e3 == pytest.approx(0.0100, abs=5e-5)
    assert b["by"] == "bytes"


@pytest.mark.parametrize("sq, causal, window, want", [
    (4, True, None, 10), (4, False, None, 16), (6, True, 2, 11), (1, True, None, 1)])
def test_visible_pairs(sq, causal, window, want):
    assert arith.visible_pairs(sq, sq, causal=causal, window=window) == want


def test_stablelm_training_flop_per_token():
    cfg = _config("stablelm-1.6b")
    assert sum(arith.layer_matmul_params(cfg)) + arith.head_params(cfg) == pytest.approx(
        1.439e9, rel=1e-3)
    per_token = arith.train_step_flop(cfg, 8, 2048) / (8 * 2048)
    assert per_token / 1e9 == pytest.approx(9.24, abs=0.01)


def test_deepseek_active_parameters_and_serving_flop():
    cfg = _config("deepseek-moe-16b")
    active = sum(arith.layer_matmul_params(cfg)) + arith.head_params(cfg)
    assert active / 1e9 == pytest.approx(2.62, abs=0.005)
    # one prompt token and no decode: the body only; lm_head once a row
    one = arith.serve_batch_flop(cfg, 1, 1, 1)
    want = 2 * active + arith.attention_flop(cfg, 1)
    assert one == pytest.approx(want)


def test_serving_flop_counts_each_decode_step_once():
    cfg = _config("deepseek-moe-16b")
    base = arith.serve_batch_flop(cfg, 2, 8, 1)
    more = arith.serve_batch_flop(cfg, 2, 8, 3)
    body = sum(arith.layer_matmul_params(cfg)) + arith.head_params(cfg)
    pairs = 2 * (9 + 10)
    assert more - base == pytest.approx(2 * 2 * 2 * body + arith.attention_flop(cfg, pairs))
