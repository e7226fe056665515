"""The other four dense configs (starcoder2-7b, granite-3-8b, stablelm-1.6b,
internvl2-26b) in the port, against the JAX package, on the CPU.

Each config's ``.smoke()`` (the reference's own reduced config: fp32, 2
layers, d_model 64) is built from the reference's own weights
(``from_jax_params``) and run through ``forward``, ``prefill`` and 12
``decode_step`` s beside the reference's ``lm.forward`` / ``prefill`` /
``decode_step`` at rtol/atol 2e-3 (item 15's gate, the tolerance of
``tests/test_pallas_model_path.py``), with internvl2-26b's ``extra_embeds``
(4 patch rows) before the prompt.  The port runs both its attention impls,
``"kernel"`` (the wrappers' CPU path) and ``"torch"``.  Then the twins of
``tests/test_arch_smoke.py``: prefill/decode consistency at 2e-4 and a loss
and gradient step's shapes and finiteness, for these four and gemma2-9b.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_params, init, jax_leaf_names

NEW = ["starcoder2-7b", "granite-3-8b", "stablelm-1.6b", "internvl2-26b"]
DENSE = ["gemma2-9b"] + NEW
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
B, PROMPT, STEPS, MAX_LEN, N_EXTRA = 2, 20, 12, 40, 4


def _extra(cfg, seed):
    if cfg.frontend != "vision":
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N_EXTRA, cfg.d_model)) * 0.02).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture(scope="module", params=NEW)
def case(request):
    """(port cfg, reference cfg, reference params as numpy, prompt, decode
    tokens, extra_embeds or None, reference outputs)."""
    name = request.param
    cfg, j_cfg = get_config(name).smoke(), j_get_config(name).smoke()
    params = jax.tree.map(np.asarray, j_lm.init(jax.random.PRNGKey(4), j_cfg))
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT))
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1))
    extra = _extra(cfg, 6)
    fwd, _, _ = j_lm.forward(params, j_cfg, jnp.asarray(prompt, jnp.int32),
                             extra_embeds=_j(extra))
    logits, caches, pos = j_lm.prefill(params, j_cfg, jnp.asarray(prompt, jnp.int32),
                                       MAX_LEN, extra_embeds=_j(extra))
    decode = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, j_cfg, t, c, q))
    dec = []
    for i, tok in enumerate(steps):
        out, caches = decode(params, jnp.asarray(tok, jnp.int32), caches, pos + i)
        dec.append(np.asarray(out))
    want = {"forward": np.asarray(fwd), "prefill": np.asarray(logits),
            "pos": int(pos), "decode": dec}
    return cfg, j_cfg, params, prompt, steps, extra, want


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_smoke_config_matches_reference(case, impl):
    cfg, _, params, prompt, steps, extra, want = case
    model = from_jax_params(cfg, params, device="cpu")
    attention.set_attention_impl(impl)
    try:
        with torch.no_grad():
            fwd, _, _ = model.forward(_t(prompt), extra_embeds=_t(extra))
        n = PROMPT + (0 if extra is None else N_EXTRA)
        assert fwd.shape == (B, n, cfg.vocab_size)
        np.testing.assert_allclose(fwd.numpy(), want["forward"], **MODEL_TOL)
        logits, caches, pos = model.prefill(_t(prompt), MAX_LEN, extra_embeds=_t(extra))
        assert int(pos) == want["pos"] == n
        np.testing.assert_allclose(logits.numpy(), want["prefill"], **MODEL_TOL)
        for i, tok in enumerate(steps):
            out, caches = model.decode_step(_t(tok), caches, pos + i)
            np.testing.assert_allclose(out.numpy(), want["decode"][i], **MODEL_TOL)
    finally:
        attention.set_attention_impl("kernel")


def test_each_reference_leaf_maps_once(case):
    cfg, _, params, _, _, _, _ = case
    model = from_jax_params(cfg, params, device="cpu")
    flat = jax_leaf_names(cfg, params)
    assert set(flat) == {n for n, _ in model.named_parameters()}
    assert sum(a.size for a in jax.tree.leaves(params)) == \
        sum(p.numel() for p in model.parameters())
    per_layer = {"layernorm": 4, "rmsnorm": 2}[cfg.norm_type] + 4 + \
        (3 if cfg.mlp_type in ("swiglu", "geglu") else 2)
    assert len(flat) == cfg.n_layers * per_layer + 1 + \
        (2 if cfg.norm_type == "layernorm" else 1) + (0 if cfg.tie_embeddings else 1)
    if cfg.norm_type == "layernorm":
        assert model.layers[0].ln1["bias"].dtype == torch.float32
        np.testing.assert_array_equal(model.final_norm["bias"].detach().numpy(),
                                      params["final_norm"]["bias"])


def test_configs_are_the_reference_configs_field_for_field():
    for name in DENSE:
        port, ref = get_config(name).__dict__, j_get_config(name).__dict__
        # the port's own fields (latent attention, YaRN) stay at their defaults
        own = {f.name: f.default for f in dataclasses.fields(ModelConfig)
               if f.name not in ref}
        assert {k: port[k] for k in ref} == ref, name
        assert {k: port[k] for k in own} == own and set(port) == set(ref) | set(own), name
    assert set(NEW) <= set(ARCHS)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_consistency(name):
    """decode_step(cache(prefill(t[:n])), t[n]) == forward(t[:n+2])[:, n],
    extra_embeds included (the twin of tests/test_arch_smoke.py:63)."""
    cfg = get_config(name).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    S = 24
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    extra = _t(_extra(cfg, 3))
    n, max_len = S - 4, S + 8
    with torch.no_grad():
        ref, _, _ = model.forward(tokens, extra_embeds=extra)
    off = 0 if extra is None else extra.shape[1]
    logits, caches, pos = model.prefill(tokens[:, :n], max_len, extra_embeds=extra)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, off + n - 1].numpy(), **tol)
    for i in range(2):
        logits, caches = model.decode_step(tokens[:, n + i:n + i + 1], caches, pos + i)
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, off + n + i].numpy(),
                                   **tol, err_msg=f"{name}: decode step {i + 1}")


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grad_step_shapes_and_finiteness(name):
    """The twin of tests/test_arch_smoke.py:39."""
    cfg = get_config(name).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 24)))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    extra = _t(_extra(cfg, 7))
    if extra is not None:
        batch["extra_embeds"] = extra
    loss, metrics = model.loss_fn(batch)
    assert torch.isfinite(loss), name
    assert set(metrics) == {"loss", "aux_loss", "tokens"}
    assert float(metrics["tokens"]) == B * 23
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert grads
    for (pname, p), g in zip(model.named_parameters(), grads):
        assert g.shape == p.shape and torch.isfinite(g).all(), (name, pname)
    with torch.no_grad():
        logits, _, _ = model.forward(batch["inputs"], extra_embeds=extra)
    assert logits.shape == (B, 23 + (0 if extra is None else N_EXTRA), cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", NEW)
def test_serve_launcher_takes_the_new_archs(name, capsys):
    serve.main(["--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3", "--max-len", "16"])
    out = capsys.readouterr().out
    assert f"arch={name}-smoke" in out and "sample tokens:" in out
