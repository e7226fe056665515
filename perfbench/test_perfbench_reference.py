"""The plain reference against the program (``repro_torch``) at tiny widths
on the CPU, both in float32 from the same seeded weights: the dense
forward, the MoE's prefill (with capacity drops) and greedy decode through
the caches, and three AdamW training steps."""

import pytest
import torch

from perfbench import compare, port, tiny, weights
from perfbench.drivers import serve_batch, train
from perfbench.harness import Context
from perfbench.reference import lm as ref_lm
from perfbench.reference import serve as ref_serve


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def _forward(w, cfg, tokens):
    x = ref_lm.embed(tokens, w)
    pos = torch.arange(tokens.shape[1])
    for i in range(cfg["n_layers"]):
        x, _ = ref_lm.decoder_layer(x, w, i, cfg, pos, ref_lm.Precision())
    return ref_lm.logits(x, w, cfg, ref_lm.Precision())


def test_dense_forward_matches_the_program(layout):
    cfg = layout.json("configs", "tiny-dense")
    w = weights.make(cfg, 11, torch.float32, "cpu")
    model = port.load_model(port.port_config(cfg), w, "cpu", torch.float32)
    tokens = weights.tokens(11, 1, 0, (2, 24), cfg["vocab_size"], "cpu")
    with torch.no_grad():
        want = model(tokens)[0]
        got = _forward(w, cfg, tokens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_prefill_and_decode_match_the_program(layout, capacity_factor):
    cfg = {**layout.json("configs", "tiny-moe"), "moe_capacity_factor": capacity_factor}
    wl = layout.json("workloads", "tiny.serve")
    ctx = Context(workload=wl, config=cfg, seed=5, device=torch.device("cpu"))
    s = serve_batch.setup(ctx)
    rec = serve_batch.item(s, 0)
    assert rec["steps"] == wl["traffic"]["new_tokens"] - 1
    served = torch.as_tensor(s.outputs[0])
    prompts = serve_batch.prompts(ctx, wl["traffic"], 0)
    T = prompts.numel()
    cap = serve_batch.capacity(cfg, T)
    if capacity_factor < 1:
        assert cap * cfg["n_experts"] < T * cfg["moe_top_k"]      # drops happen
    w = weights.make(cfg, 5, torch.float32, "cpu")
    logits, chosen = ref_serve.chosen_logits(w, cfg, prompts, served,
                                             list(range(prompts.shape[0])), cap,
                                             ref_lm.Precision())
    assert chosen.numel() == prompts.shape[0] * wl["traffic"]["new_tokens"]
    assert float(ref_serve.gaps(logits, chosen).max()) < 1e-4
    with torch.no_grad():
        model = port.load_model(port.port_config(cfg), w, "cpu", torch.float32)
        first = model.prefill(prompts, 64)[0][:, -1]
    torch.testing.assert_close(logits[:prompts.shape[0]], first, rtol=1e-5, atol=1e-5)


def test_training_steps_match_the_program(layout):
    wl = layout.json("workloads", "tiny.train")
    cfg = layout.json("configs", wl["config"])
    ctx = Context(workload=wl, config=cfg, seed=9, device=torch.device("cpu"))
    s = train.setup(ctx)
    train.free(s)
    ref = train.reference(ctx, wl["traffic"])
    for c in compare.training(s.program, ref, wl["limits"]):
        assert c["value"] < 1e-5, c
