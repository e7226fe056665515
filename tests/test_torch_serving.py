"""The port's ``Server`` against the JAX package's, on the CPU.

Both serve gemma2-9b's smoke config with the reference's own weights; the
port's model comes from ``from_jax_params``.  Greedy decoding must give the
same tokens, and ``generate`` the same ``stats``, as
``tests/test_runtime_serving.py`` checks of the reference.  The prompts are
longer than the smoke window of 16, so the local layers' rings wrap.
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models import lm as j_lm
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro_torch.configs import get_config
from repro_torch.models.weights import from_jax_params
from repro_torch.obs import observe
from repro_torch.runtime.decode_graph import GreedyDecoder
from repro_torch.runtime.serve_loop import Request, Server

MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    cfg = get_config("gemma2-9b").smoke()
    j_cfg = j_get_config("gemma2-9b").smoke()
    params = j_lm.init(jax.random.PRNGKey(0), j_cfg)
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, j_cfg, params, model


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(2, 256, n).tolist() for n in (24, 19, 30)]


@pytest.mark.parametrize("j_impl", ["xla", "pallas"])
def test_throughput_batch_matches_reference_tokens(models, j_impl):
    cfg, j_cfg, params, model = models
    prompts = np.random.default_rng(5).integers(2, cfg.vocab_size, (2, 24))
    j_attention.set_attention_impl(j_impl)
    try:
        want = JServer(j_cfg, params, max_len=MAX_LEN).throughput_batch(prompts, 8)
    finally:
        j_attention.set_attention_impl("xla")
    got = Server(cfg, model, max_len=MAX_LEN, device="cpu").throughput_batch(prompts, 8)
    assert got["output"].shape == (2, 8) and got["tokens"] == 16
    np.testing.assert_array_equal(got["output"], np.asarray(want["output"]))
    assert got["tok_per_s"] > 0 and got["prefill_s"] > 0


def test_generate_matches_reference_tokens_and_stats(models):
    cfg, j_cfg, params, model = models
    j_server = JServer(j_cfg, params, max_len=MAX_LEN)
    j_reqs = [JRequest(rid=i, prompt=p, max_new_tokens=5 + i)
              for i, p in enumerate(_prompts())]
    j_server.generate(j_reqs, max_slots=2)

    server = Server(cfg, model, max_len=MAX_LEN, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5 + i)
            for i, p in enumerate(_prompts())]
    t0 = time.perf_counter()
    with observe() as ob:
        server.generate(reqs, max_slots=2)
    wall = time.perf_counter() - t0
    assert [r.generated for r in reqs] == [r.generated for r in j_reqs]
    assert dict(server.stats) == dict(j_server.stats)
    # two slots: r0 and r1 tick together 4 times, then r1 and r2 once, then
    # r2 alone 5 times
    assert dict(server.stats) == {"prefills": 3, "decode_ticks": 10,
                                  "tokens_out": 15}
    assert all(r.done and 0 < r.latency_s <= wall for r in reqs)
    assert server.latency.count == 3 and server.latency.p50 > 0
    assert server.metrics.histogram("server.latency_s").count == 3
    begins = [e for e in ob.tracer.events() if e["ph"] == "B"]
    assert [e["name"] for e in begins] == ["server.prefill"] * 3
    assert [e["args"]["prompt_len"] for e in begins] == [24, 19, 30]
    ticks = [e for e in ob.tracer.events() if e["name"] == "server"]
    assert len(ticks) == 10 and ticks[0]["args"]["tokens_per_tick"] == 2


def test_slot_limit_changes_no_token(models):
    cfg, _, _, model = models
    outs = []
    for slots in (None, 1):
        server = Server(cfg, model, max_len=MAX_LEN, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(_prompts())]
        server.generate(reqs, max_slots=slots)
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]


def test_sampling_is_seeded(models):
    cfg, _, _, model = models
    runs = []
    for _ in range(2):
        server = Server(cfg, model, max_len=MAX_LEN, temperature=1.0, device="cpu")
        reqs = [Request(rid=0, prompt=_prompts()[0], max_new_tokens=6)]
        server.generate(reqs)
        runs.append(reqs[0].generated)
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size for t in runs[0])


def test_requests_that_overflow_the_caches_are_refused(models):
    cfg, _, _, model = models
    server = Server(cfg, model, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        server.generate([Request(rid=0, prompt=[3] * 30, max_new_tokens=4)])
    with pytest.raises(ValueError, match="max_len"):
        server.throughput_batch(np.full((1, 30), 3), 4)
    out = server.throughput_batch(np.full((1, 30), 3), 3)   # positions 30, 31
    assert out["output"].shape == (1, 3)


def test_server_needs_a_card_unless_given_the_cpu(models, monkeypatch):
    cfg, _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, model, max_len=MAX_LEN)


def test_static_buffer_decoder_matches_eager_loop_and_reference(models):
    # the unit a CUDA graph replays, run eagerly on the CPU: the same greedy
    # tokens as a loop that rebinds token and position every step, and as
    # the reference's throughput_batch; its inputs keep their addresses
    cfg, j_cfg, params, model = models
    prompts = np.random.default_rng(7).integers(2, cfg.vocab_size, (2, 20))
    toks = torch.as_tensor(prompts, dtype=torch.long)
    logits, caches, pos = model.prefill(toks, MAX_LEN)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    eager = [tok]
    for _ in range(9):
        logits, caches = model.decode_step(eager[-1], caches, pos)
        eager.append(torch.argmax(logits[:, -1:], dim=-1))
        pos = pos + 1

    logits, caches, pos = model.prefill(toks, MAX_LEN)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    decoder = GreedyDecoder(model, caches, tok, pos, cuda_graph=False)
    ptrs = (decoder.token.data_ptr(), decoder.pos.data_ptr())
    static = [tok] + [decoder.step().clone() for _ in range(9)]
    assert (decoder.token.data_ptr(), decoder.pos.data_ptr()) == ptrs
    assert int(decoder.pos) == 20 + 9 and decoder.steps == 9
    assert decoder.capture_s == 0.0 and decoder.logits.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_array_equal(torch.cat(static, 1).numpy(),
                                  torch.cat(eager, 1).numpy())
    want = JServer(j_cfg, params, max_len=MAX_LEN).throughput_batch(prompts, 10)
    np.testing.assert_array_equal(torch.cat(static, 1).numpy(),
                                  np.asarray(want["output"]))


def test_cuda_graph_needs_a_model_on_the_card(models):
    cfg, _, _, model = models
    logits, caches, pos = model.prefill(torch.full((1, 8), 3), MAX_LEN)
    with pytest.raises(ValueError, match="CUDA"):
        GreedyDecoder(model, caches, logits.argmax(-1), pos, cuda_graph=True)
    server = Server(cfg, model, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        server.throughput_batch(np.full((1, 8), 3), 3, cuda_graph=True)
    out = server.throughput_batch(np.full((1, 8), 3), 3)
    assert out["cuda_graph"] is False and out["capture_s"] == 0.0
