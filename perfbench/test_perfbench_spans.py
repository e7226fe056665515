"""The program's spans on the tiny cells' configurations, on the CPU: a
profiled ``Server.throughput_batch`` (eager decode steps) nests prefill,
decode and release under its batch and the four MoE ranges under prefill,
in both dispatches, and serves the same tokens traced or not; a training
step has one optimizer range."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import port, tiny, weights
from perfbench.trace import reduce_events

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def _model(layout, name):
    conf = layout.json("configs", name)
    cfg = port.port_config(conf)
    return cfg, port.load_model(cfg, weights.make(conf, SEED, torch.float32, "cpu"),
                                "cpu", torch.float32)


def _tree(event) -> list[str]:
    return [event.name] + [n for c in event.cpu_children for n in _tree(c)]


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_serving_spans_nest_and_change_no_token(layout, impl):
    from repro_torch.models.opt_flags import OptFlags, clear_flags, set_flags
    from repro_torch.obs import observe
    from repro_torch.runtime.serve_loop import Server

    cfg, model = _model(layout, "tiny-moe")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    set_flags(OptFlags(moe_impl=impl))
    try:
        server = Server(cfg, model, max_len=18, device="cpu")
        plain = server.throughput_batch(prompts, 5, cuda_graph=False)
        with observe() as ob, profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = server.throughput_batch(prompts, 5, cuda_graph=False)
    finally:
        clear_flags()
    np.testing.assert_array_equal(traced["output"], plain["output"])
    assert server.metrics.counter("server.batches").value == 2
    assert server.metrics.counter("server.graph_captures").value == 0

    host = reduce_events(prof.events(), 1.0, 1).host
    (batch,) = [e for e in host if e.name == "server.batch"]
    under = [c.name for c in batch.cpu_children if c.name.startswith("server.")]
    assert under == ["server.prefill", "server.decode", "server.release"]
    (prefill,) = [c for c in batch.cpu_children if c.name == "server.prefill"]
    moe = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
    names = _tree(prefill)
    assert moe <= set(names)
    # two MoE layers of three, each range once a layer, the shared experts apart
    assert [names.count(n) for n in sorted(moe)] == [2, 2, 4, 2]

    begins = [e["name"] for e in ob.tracer.events() if e["ph"] == "B"]
    assert begins[:2] == ["server.batch", "server.prefill"]
    assert begins.count("server.decode") == begins.count("server.release") == 1


def test_a_train_step_has_one_optimizer_range(layout):
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, model = _model(layout, "tiny-dense")
    traffic = layout.json("workloads", "tiny.train")["traffic"]
    step = steps.make_train_step(cfg, AdamWConfig(**traffic["optimizer"]), 2)
    ids = torch.randint(cfg.vocab_size, (4, 17), generator=torch.Generator().manual_seed(1))
    state = adamw_init(dict(model.named_parameters()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, state, {"inputs": ids[:, :-1], "targets": ids[:, 1:]})
    (opt,) = [e for e in prof.events() if e.name == "train_step.optimizer"]
    assert any(c.name == "aten::copy_" for c in opt.cpu_children)
