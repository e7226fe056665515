"""Slice 5b's configs in the port against the JAX package on the CPU:
deepseek-moe-16b and moonshot-v1-16b-a3b (MoE with a dense first layer),
mamba2-130m (SSD) and recurrentgemma-9b (RG-LRU prefix layers, then RG-LRU
and local attention), and seamless-m4t-large-v2 (enc-dec) where it shares
a check.

Each decoder-only config's ``.smoke()`` (fp32, d_model 64) is built from
the reference's own weights (``from_jax_params``) and run through
``forward`` (with its MoE aux loss), ``loss_fn``, ``prefill`` and 12
``decode_step`` s beside the reference at rtol/atol 2e-3 (``MODEL_TOL``,
as ``tests/test_torch_dense.py``), under both attention impls.  Then the
twins of ``tests/test_arch_smoke.py`` (prefill/decode consistency at 2e-4,
a loss and gradient step's shapes and finiteness, the enc-dec train step),
``make_train_step`` against the reference's for a MoE and the enc-dec
config, every reference leaf mapped once, ``init``'s scale of every leaf
against the reference's ``init``, and the serve launcher.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.models import encdec as j_ed
from repro.models import lm as j_lm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve, steps
from repro_torch.models import attention
from repro_torch.models.lm import LM, layer_kinds
from repro_torch.models.weights import from_jax_params, init, jax_leaf_names
from repro_torch.optim import AdamWConfig, adamw_init

DECODERS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b", "mamba2-130m", "recurrentgemma-9b"]
ENCDEC = "seamless-m4t-large-v2"
NEW = DECODERS + [ENCDEC]
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
B, PROMPT, STEPS, MAX_LEN = 2, 20, 12, 40


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ref_params(name, seed):
    cfg, j_cfg = get_config(name).smoke(), j_get_config(name).smoke()
    init_fn = j_ed.init_encdec if cfg.is_encdec else j_lm.init
    return cfg, j_cfg, jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed), j_cfg))


@pytest.fixture(scope="module", params=DECODERS)
def case(request):
    """(port cfg, reference params as numpy, prompt, decode tokens, batch,
    reference outputs)."""
    name = request.param
    cfg, j_cfg, params = _ref_params(name, 4)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT))
    steps_ = rng.integers(0, cfg.vocab_size, (STEPS, B, 1))
    batch = {"inputs": prompt[:, :-1], "targets": prompt[:, 1:]}
    # jitted: compiling each function once beats running the reference op by op
    fwd, _, aux = jax.jit(lambda p, t: j_lm.forward(p, j_cfg, t))(
        params, jnp.asarray(prompt, jnp.int32))
    total, metrics = jax.jit(lambda p, b: j_lm.loss_fn(p, j_cfg, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, caches, pos = jax.jit(lambda p, t: j_lm.prefill(p, j_cfg, t, MAX_LEN))(
        params, jnp.asarray(prompt, jnp.int32))
    decode = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, j_cfg, t, c, q))
    dec = []
    for i, tok in enumerate(steps_):
        out, caches = decode(params, jnp.asarray(tok, jnp.int32), caches, pos + i)
        dec.append(np.asarray(out))
    want = {"forward": np.asarray(fwd), "aux": float(aux), "total": float(total),
            "loss": float(metrics["loss"]), "prefill": np.asarray(logits),
            "pos": int(pos), "decode": dec}
    return cfg, params, prompt, steps_, batch, want


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_smoke_config_matches_reference(case, impl):
    cfg, params, prompt, steps_, batch, want = case
    model = from_jax_params(cfg, params, device="cpu")
    attention.set_attention_impl(impl)
    try:
        with torch.no_grad():
            fwd, _, aux = model.forward(_t(prompt))
            assert fwd.shape == (B, PROMPT, cfg.vocab_size)
            np.testing.assert_allclose(fwd.numpy(), want["forward"], **MODEL_TOL)
            np.testing.assert_allclose(float(aux), want["aux"], rtol=1e-5, atol=1e-6)
            assert (float(aux) > 0) == bool(cfg.n_experts)
            total, metrics = model.loss_fn({k: _t(v) for k, v in batch.items()})
            np.testing.assert_allclose(float(total), want["total"], rtol=1e-5)
            np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=1e-5)
        logits, caches, pos = model.prefill(_t(prompt), MAX_LEN)
        assert int(pos) == want["pos"] == PROMPT
        np.testing.assert_allclose(logits.numpy(), want["prefill"], **MODEL_TOL)
        for i, tok in enumerate(steps_):
            out, caches = model.decode_step(_t(tok), caches, pos + i)
            np.testing.assert_allclose(out.numpy(), want["decode"][i], **MODEL_TOL,
                                       err_msg=f"decode step {i + 1}")
    finally:
        attention.set_attention_impl("kernel")


def test_decode_writes_the_caches_in_place(case):
    """A replayed CUDA graph reads the same buffers every step: every cache
    and recurrent state keeps its tensor (its storage) across decode steps."""
    cfg, params, prompt, steps_, _, _ = case
    model = from_jax_params(cfg, params, device="cpu")
    _, caches, pos = model.prefill(_t(prompt), MAX_LEN)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in caches]
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    _, out = model.decode_step(_t(steps_[0]), caches, pos)
    assert out is caches
    assert [{k: v.data_ptr() for k, v in c.items()} for c in caches] == ptrs
    kinds = layer_kinds(cfg)
    for kind, c, b in zip(kinds, caches, before):
        changed = [not torch.equal(c[k], b[k]) for k in c]
        assert any(changed), kind
        if kind in ("rglru", "ssm"):
            assert set(c) == {"h", "conv"} and c["h"].dtype == torch.float32


def test_each_reference_leaf_maps_once():
    for name in NEW:
        cfg, _, params = _ref_params(name, 0)
        model = from_jax_params(cfg, params, device="cpu")
        flat = jax_leaf_names(cfg, params)
        assert set(flat) == {n for n, _ in model.named_parameters()}, name
        assert sum(a.size for a in jax.tree.leaves(params)) == \
            sum(p.numel() for p in model.parameters()), name
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(flat[n], np.float32),
                                          err_msg=n)
    # the prefix comes first: recurrentgemma's two RG-LRU layers, a MoE
    # config's dense layer (d_ff_dense wide)
    rg_cfg, _, rg_params = _ref_params("recurrentgemma-9b", 0)
    rg = from_jax_params(rg_cfg, rg_params, device="cpu")
    assert [layer.kind for layer in rg.layers] == layer_kinds(rg_cfg) == \
        ["rglru", "rglru", "rglru", "rglru", "local", "rglru", "rglru", "local"]
    ds_cfg = get_config("deepseek-moe-16b").smoke()
    ds = LM(ds_cfg, device="cpu")
    assert ds.layers[0].kind == "attn_dense"
    assert ds.layers[0].mlp["wo"].shape == (ds_cfg.d_ff_dense, ds_cfg.d_model)
    assert all(layer.ffn == "moe" for layer in ds.layers[1:])


def test_recurrent_gate_parameters_stay_fp32():
    cfg = get_config("recurrentgemma-9b").smoke().replace(dtype="bfloat16")
    model = LM(cfg, device="cpu")
    dtypes = {n: p.dtype for n, p in model.layers[0].named_parameters()}
    assert {dtypes[k] for k in ("rglru.wa", "rglru.wx", "rglru.ba", "rglru.bx",
                                "rglru.lam")} == {torch.float32}
    assert dtypes["rglru.in_x"] == dtypes["rglru.out"] == torch.bfloat16
    m = LM(get_config("mamba2-130m").smoke().replace(dtype="bfloat16"), device="cpu")
    d2 = {n: p.dtype for n, p in m.layers[0].named_parameters()}
    assert {d2[k] for k in ("ssm.A_log", "ssm.D", "ssm.dt_bias",
                            "ssm.norm.scale")} == {torch.float32}
    assert d2["ssm.in_proj"] == torch.bfloat16


@pytest.mark.parametrize("name", NEW)
def test_init_scales_match_the_reference_init(name):
    """Every leaf's std (and mean) from the port's ``init`` against the
    reference's ``init`` of the same config: within 15 % for random leaves,
    exactly for constant ones (norms, biases, A_log, D, dt_bias, lam)."""
    cfg, _, params = _ref_params(name, 0)
    cfg = cfg.replace(vocab_size=2048)
    init_fn = j_ed.init_encdec if cfg.is_encdec else j_lm.init
    params = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0), j_get_config(name)
                                              .smoke().replace(vocab_size=2048)))
    want = jax_leaf_names(cfg, params)
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for n, p in model.named_parameters():
        got, ref = p.detach().double().numpy(), np.asarray(want[n], np.float64)
        if ref.std() == 0 or n.endswith(".lam"):
            np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=n)
        else:
            assert abs(got.std() / ref.std() - 1) < 0.15, (n, got.std(), ref.std())
            assert abs(got.mean()) < 0.2 * ref.std(), n


def test_configs_are_the_reference_configs_field_for_field():
    assert list(ARCHS) == list(J_ARCHS)
    for name in ARCHS:
        assert get_config(name).__dict__ == j_get_config(name).__dict__, name


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_decode_consistency(name):
    """decode_step(cache(prefill(t[:n])), t[n]) == forward(t[:n+2])[:, n]
    (the twin of tests/test_arch_smoke.py:63)."""
    cfg = get_config(name).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    S = 24
    tokens = _t(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    n = S - 4
    with torch.no_grad():
        ref, _, _ = model.forward(tokens)
    logits, caches, pos = model.prefill(tokens[:, :n], S + 8)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, n - 1].numpy(), **tol)
    for i in range(2):
        logits, caches = model.decode_step(tokens[:, n + i:n + i + 1], caches, pos + i)
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, n + i].numpy(), **tol,
                                   err_msg=f"{name}: decode step {i + 1}")


def test_encdec_prefill_decode_consistency():
    """The twin of tests/test_arch_smoke.py:111."""
    cfg = get_config(ENCDEC).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32) * 0.02)
    tgt = _t(rng.integers(0, cfg.vocab_size, (B, 12)))
    n = 8
    with torch.no_grad():
        ref, _ = model.forward(src, tgt)
    logits, caches, pos = model.prefill(src, tgt[:, :n], 16)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, n - 1].numpy(), **tol)
    logits, _ = model.decode_step(tgt[:, n:n + 1], caches, pos)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, n].numpy(), **tol)


@pytest.mark.parametrize("name", NEW)
def test_loss_and_grad_step_shapes_and_finiteness(name):
    """The twins of tests/test_arch_smoke.py:39 and :96."""
    cfg = get_config(name).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    tokens = _t(rng.integers(0, cfg.vocab_size, (B, 24)))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32) * 0.02)
    loss, metrics = model.loss_fn(batch)
    assert torch.isfinite(loss), name
    assert float(metrics["tokens"]) == B * 23
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for (pname, p), g in zip(model.named_parameters(), grads):
        assert g.shape == p.shape and torch.isfinite(g).all(), (name, pname)
    if not cfg.is_encdec:
        assert set(metrics) == {"loss", "aux_loss", "tokens"}
        with torch.no_grad():
            logits, _, _ = model.forward(batch["inputs"])
        assert logits.shape == (B, 23, cfg.vocab_size) and torch.isfinite(logits).all()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", ENCDEC])
def test_train_step_matches_reference(name):
    """``make_train_step`` (2 microbatches, remat) against the reference's:
    the loss (with the MoE aux term), the gradient norm and every parameter
    after one AdamW step."""
    cfg, j_cfg, params = _ref_params(name, 2)
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (4, 13))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.is_encdec:
        batch["src_embeds"] = rng.standard_normal((4, 10, cfg.d_model)).astype(np.float32)
    j_params, _, j_metrics = jax.jit(j_steps.make_train_step(j_cfg, JAdamWConfig(**opt), 2))(
        params, j_adamw_init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    model = from_jax_params(cfg, params, device="cpu", param_dtype=torch.float32)
    step = steps.make_train_step(cfg, AdamWConfig(**opt), 2)
    model, state, metrics = step(model, adamw_init(dict(model.named_parameters())), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    want = jax_leaf_names(cfg, jax.tree.map(np.asarray, j_params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5, atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("name", DECODERS)
def test_serve_launcher_takes_the_new_archs(name, capsys):
    serve.main(["--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3", "--max-len", "16"])
    out = capsys.readouterr().out
    assert f"arch={name}-smoke" in out and "sample tokens:" in out


def test_serve_launcher_refuses_the_encdec():
    assert ENCDEC not in serve.SERVABLE and set(DECODERS) <= set(serve.SERVABLE)
    with pytest.raises(SystemExit):
        serve.main(["--arch", ENCDEC, "--smoke", "--device", "cpu"])
