"""The port's encoder-decoder (``repro_torch.models.encdec.EncDec``) against
the JAX package's ``repro.models.encdec`` on the CPU.

seamless-m4t-large-v2's ``.smoke()`` (fp32: 2 encoder and 2 decoder layers,
d_model 64, LayerNorm, GELU, tied embeddings) is built from the reference's
own weights (``from_jax_params``) and run beside the reference through
``encode``, the teacher-forced ``forward``, ``prefill``, 12 decode steps
and ``loss_fn`` (with and without a mask), at rtol/atol 2e-3 (``MODEL_TOL``)
under both attention impls (the decoder embeds its tokens without the
``sqrt(d)`` scale, as the reference does), and its gradients against the
reference's.  Then the cross pos rides with the caches, and the ``Server``
refuses an enc-dec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import encdec as j_ed
from repro_torch.configs import get_config
from repro_torch.models import attention
from repro_torch.models.encdec import EncDec
from repro_torch.models.weights import from_jax_params, init
from repro_torch.runtime.serve_loop import Server

NAME = "seamless-m4t-large-v2"
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
B, S_SRC, PROMPT, STEPS, MAX_LEN = 2, 24, 10, 12, 32


@pytest.fixture(scope="module")
def case():
    cfg, j_cfg = get_config(NAME).smoke(), j_get_config(NAME).smoke()
    params = jax.tree.map(np.asarray, j_ed.init_encdec(jax.random.PRNGKey(7), j_cfg))
    rng = np.random.default_rng(8)
    src = rng.standard_normal((B, S_SRC, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT))
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1))
    mask = (rng.uniform(size=(B, PROMPT - 1)) > 0.3).astype(np.float32)
    # jitted: compiling each function once beats running the reference op by op
    enc = jax.jit(lambda p, s: j_ed.encode(p, j_cfg, s))(params, jnp.asarray(src))
    fwd, _ = jax.jit(lambda p, s, t: j_ed.forward_encdec(p, j_cfg, s, t))(
        params, jnp.asarray(src), jnp.asarray(prompt))
    prefill = jax.jit(lambda p, s, t: j_ed.prefill_encdec(p, j_cfg, s, t, MAX_LEN))
    logits, caches, pos = prefill(params, jnp.asarray(src), jnp.asarray(prompt))
    decode = jax.jit(lambda p, t, c, q: j_ed.decode_step_encdec(p, j_cfg, t, c, q))
    dec = []
    for i, tok in enumerate(steps):
        out, caches = decode(params, jnp.asarray(tok), caches, pos + i)
        dec.append(np.asarray(out))
    batch = {"src_embeds": src, "inputs": prompt[:, :-1], "targets": prompt[:, 1:]}
    loss_fn = jax.jit(lambda p, b: j_ed.loss_fn_encdec(p, j_cfg, b)[0])
    loss = loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    masked = loss_fn(params, {**{k: jnp.asarray(v) for k, v in batch.items()},
                              "mask": jnp.asarray(mask)})
    want = {"encode": np.asarray(enc), "forward": np.asarray(fwd),
            "prefill": np.asarray(logits), "pos": int(pos), "decode": dec,
            "loss": float(loss), "masked": float(masked)}
    return cfg, j_cfg, params, src, prompt, steps, batch, mask, want


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_encdec_matches_reference(case, impl):
    cfg, _, params, src, prompt, steps, batch, mask, want = case
    model = from_jax_params(cfg, params, device="cpu")
    assert isinstance(model, EncDec)
    attention.set_attention_impl(impl)
    try:
        with torch.no_grad():
            np.testing.assert_allclose(model.encode(_t(src)).numpy(), want["encode"],
                                       **MODEL_TOL)
            fwd, caches = model.forward(_t(src), _t(prompt))
            assert caches is None and fwd.shape == (B, PROMPT, cfg.vocab_size)
            np.testing.assert_allclose(fwd.numpy(), want["forward"], **MODEL_TOL)
            loss, metrics = model.loss_fn({k: _t(v) for k, v in batch.items()})
            np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
            assert set(metrics) == {"loss", "tokens"}
            masked, metrics = model.loss_fn({**{k: _t(v) for k, v in batch.items()},
                                             "mask": _t(mask)})
            np.testing.assert_allclose(float(masked), want["masked"], rtol=1e-5)
            assert float(metrics["tokens"]) == mask.sum()
        logits, caches, pos = model.prefill(_t(src), _t(prompt), MAX_LEN)
        assert int(pos) == want["pos"] == PROMPT
        assert int(caches["cross_pos"]) == S_SRC
        np.testing.assert_allclose(logits.numpy(), want["prefill"], **MODEL_TOL)
        for i, tok in enumerate(steps):
            out, caches = model.decode_step(_t(tok), caches, pos + i)
            np.testing.assert_allclose(out.numpy(), want["decode"][i], **MODEL_TOL,
                                       err_msg=f"decode step {i + 1}")
    finally:
        attention.set_attention_impl("kernel")


def test_encdec_gradients_match_reference(case):
    cfg, j_cfg, params, _, _, _, batch, _, _ = case
    j_grads = jax.jit(jax.grad(lambda p: j_ed.loss_fn_encdec(
        p, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(
            jax.tree.map(jnp.asarray, params))
    model = from_jax_params(cfg, params, device="cpu")
    loss, _ = model.loss_fn({k: _t(v) for k, v in batch.items()})
    named = dict(model.named_parameters())
    picks = {"embed": j_grads["embed"], "enc.0.attn.q": j_grads["enc"]["attn"]["q"][0],
             "dec.1.cross.k": j_grads["dec"]["cross"]["k"][1],
             "dec.0.mlp.wo": j_grads["dec"]["mlp"]["wo"][0],
             "enc_norm.bias": j_grads["enc_norm"]["bias"]}
    grads = torch.autograd.grad(loss, [named[k] for k in picks])
    for (name, want), got in zip(picks.items(), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_cache_spec_and_cross_pos():
    cfg = get_config(NAME).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = model.cache_spec(3, 40, 17)
    assert len(caches["self"]) == len(caches["cross"]) == cfg.n_layers
    assert caches["self"][0]["k"].shape == (3, cfg.n_kv_heads, 40, cfg.head_dim)
    assert caches["cross"][1]["v"].shape == (3, cfg.n_kv_heads, 17, cfg.head_dim)
    assert caches["cross_pos"].dtype == torch.int32 and int(caches["cross_pos"]) == 17


def test_server_refuses_an_encdec_config():
    cfg = get_config(NAME).smoke()
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        Server(cfg, model, max_len=32, device="cpu")
