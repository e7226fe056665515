"""The comparison that decides ``correct`` fails what it must: the control
(the reference in fp8, the next precision below the configurations' bf16
compute, put in the program's place) and each fault a cell can have,
planted in the program under an otherwise whole run on the CPU."""

import numpy as np
import pytest
import torch

from perfbench import calibrate, tiny
from perfbench.harness import Context


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def _ctx(layout, cell, seed):
    wl = layout.json("workloads", cell)
    return Context(workload=wl, config=layout.json("configs", wl["config"]), seed=seed,
                   device=torch.device("cpu"))


@pytest.mark.parametrize("seed", [3, 2**40 + 17, 2**31 + 5])
def test_training_control_fails_and_sound_runs_pass(layout, seed):
    ctx = _ctx(layout, "tiny.train", seed)
    got = calibrate.train_seed(layout.module("drivers", "train"), ctx, True)
    limits = ctx.workload["limits"]
    assert all(v <= limits[k] for k, v in got["program"].items()), got["program"]
    for reading in ("control", "half_batch", "unchanged"):
        assert any(v > limits[k] for k, v in got[reading].items()), (reading, got)


@pytest.mark.parametrize("seed", [4, 2**40 + 19, 2**31 + 9])
def test_serving_control_fails_and_sound_runs_pass(layout, seed):
    ctx = _ctx(layout, "tiny.serve", seed)
    ctx.config["dtype"] = "float32"
    got = calibrate.serve_seed(layout.module("drivers", "serve_batch"), ctx, True)
    limit = ctx.workload["limits"]["logit_gap_mean"]
    assert got["program"]["logit_gap_mean"] <= limit < got["control"]["logit_gap_mean"], got


def _unchanged_step(orig):
    from repro_torch.launch import steps

    def make(cfg, opt, n):
        def step(model, state, batch):
            _, loss = steps.accumulate_grads(model, batch, n)
            return model, state, {"loss": loss}
        return step
    return make


def _half_batch_step(orig):
    def make(cfg, opt, n):
        real = orig(cfg, opt, n)

        def step(model, state, batch):
            rows = batch["inputs"].shape[0] // 2
            return real(model, state, {k: v[:rows] for k, v in batch.items()})
        return step
    return make


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step])
def test_training_faults_come_out_incorrect(layout, monkeypatch, fault):
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "make_train_step", fault(steps.make_train_step))
    assert tiny.run_cell(layout, "tiny.train")["correct"] is False


def _altered_token(orig):
    def batch(self, prompts, new_tokens, **kw):
        out = orig(self, prompts, new_tokens, **kw)
        out["output"] = out["output"].copy()
        out["output"][:, new_tokens // 2] = (out["output"][:, new_tokens // 2] + 1) % 256
        return out
    return batch


def _half_batch(orig):
    def batch(self, prompts, new_tokens, **kw):
        half = orig(self, prompts[: len(prompts) // 2], new_tokens, **kw)
        half["output"] = np.concatenate([half["output"]] * 2)
        return half
    return batch


@pytest.mark.parametrize("fault", [_altered_token, _half_batch])
def test_serving_faults_come_out_incorrect(layout, monkeypatch, fault):
    from repro_torch.runtime.serve_loop import Server

    monkeypatch.setattr(Server, "throughput_batch", fault(Server.throughput_batch))
    assert tiny.run_cell(layout, "tiny.serve")["correct"] is False


def test_a_decode_state_left_unchanged_comes_out_incorrect(layout, monkeypatch):
    from repro_torch.runtime.decode_graph import GreedyDecoder

    def stuck(self):
        logits, _ = self.model.decode_step(self.token, self.caches, self.pos)
        self.token.copy_(torch.argmax(logits[:, -1:], dim=-1))
        return logits                        # the position never advances

    monkeypatch.setattr(GreedyDecoder, "_run", stuck)
    assert tiny.run_cell(layout, "tiny.serve")["correct"] is False


def _norms_ignored(w: dict) -> dict:
    return {k: (torch.ones_like(v) if k.endswith(".scale") else torch.zeros_like(v))
            if k.endswith((".scale", ".bias")) else v for k, v in w.items()}


def _norms_swapped(w: dict) -> dict:
    out = dict(w)
    for k in w:
        if ".ln1." in k:
            out[k], out[k.replace(".ln1.", ".ln2.")] = w[k.replace(".ln1.", ".ln2.")], w[k]
    return out


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
@pytest.mark.parametrize("fault", [_norms_ignored, _norms_swapped])
def test_norm_weights_ignored_or_swapped_come_out_incorrect(layout, monkeypatch, cell,
                                                            fault):
    from perfbench import port

    load = port.load_model
    monkeypatch.setattr(port, "load_model",
                        lambda cfg, w, *a, **kw: load(cfg, fault(w), *a, **kw))
    assert tiny.run_cell(layout, cell)["correct"] is False
