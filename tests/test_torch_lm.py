"""The port's LM layers and model against the JAX package's, on the CPU.

Layers are held in fp32 at rtol 1e-6 (the same arithmetic, in another
framework).  The model is gemma2-9b's smoke config with the reference's own
weights (``from_jax_params``): a 48-token prompt, longer than the smoke
window of 16, so the local layers' ring caches wrap; ``forward`` logits,
``prefill`` logits and caches, then 20 ``decode_step`` s are held against the
reference at rtol/atol 2e-3, the tolerance of
``tests/test_pallas_model_path.py``.  The caches hold max_len 72 positions:
the 48 + 20 positions the test writes need 68 slots (the reference silently
clamps a write past its full cache; the port would index out of range).  The
reference runs both ways its own tests run it, ``"pallas"`` (interpret mode)
and ``"xla"``; the port runs both of its impls, ``"kernel"`` (the wrappers'
CPU path) and ``"torch"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro_torch.configs import get_config
from repro_torch.models import attention, layers
from repro_torch.models.lm import LM
from repro_torch.models.opt_flags import OptFlags, set_flags
from repro_torch.models.weights import from_jax_params, init, jax_leaf_names

RTOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
PROMPT, MAX_LEN, STEPS = 48, 72, 20


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_matches(norm_type):
    x = _rand(0, 3, 5, 64) * 3.0 + 1.0
    p = {"scale": _rand(1, 64), "bias": _rand(2, 64)}
    want = j_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), norm_type, 1e-6)
    got = layers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), norm_type, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(mlp_type):
    x = _rand(3, 2, 7, 32)
    p = {"wi": _rand(4, 32, 48) * 0.2, "wg": _rand(5, 32, 48) * 0.2,
         "wo": _rand(6, 48, 32) * 0.2}
    want = j_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), mlp_type)
    got = layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)


def test_geglu_is_the_tanh_gelu():
    # jax.nn.gelu defaults to approximate=True; the exact erf GELU differs
    x = _rand(7, 4, 16)
    p = {"wi": np.eye(16, dtype=np.float32), "wg": np.eye(16, dtype=np.float32),
         "wo": np.eye(16, dtype=np.float32)}
    got = layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), "geglu")
    tanh = torch.nn.functional.gelu(_t(x), approximate="tanh") * _t(x)
    exact = torch.nn.functional.gelu(_t(x)) * _t(x)
    assert torch.equal(got, tanh) and not torch.allclose(got, exact, rtol=1e-6)


@pytest.mark.parametrize("head_dim,fraction", [(16, 1.0), (64, 0.25), (256, 1.0)])
def test_rope_matches(head_dim, fraction):
    inv_freq = j_layers.rope_frequencies(head_dim, fraction, 10_000.0)
    np.testing.assert_allclose(
        layers.rope_frequencies(head_dim, fraction, 10_000.0).numpy(),
        np.asarray(inv_freq), **RTOL)
    x = _rand(8, 2, 3, 40, head_dim)
    positions = np.arange(40, dtype=np.int32)[None, None, :] + 5
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions), inv_freq)
    got = layers.apply_rope(_t(x), _t(positions), _t(inv_freq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)


def test_rope_rotates_interleaved_pairs():
    # pairs are (x[0], x[1]), (x[2], x[3]), ...: not the half-split convention
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.tensor([[[1]]]), torch.tensor([1.0, 0.0]))
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               [np.cos(1.0), np.sin(1.0), 0.0, 0.0], rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_softcap_matches(dtype):
    x = _rand(9, 4, 33) * 80.0
    want = np.asarray(j_layers.softcap(jnp.asarray(x, dtype), 30.0).astype(jnp.float32))
    t_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = layers.softcap(_t(x).to(t_dtype), 30.0)
    assert got.dtype == t_dtype
    np.testing.assert_allclose(got.float().numpy(), want, **RTOL)
    t = _t(x)
    assert layers.softcap(t, None) is t


def test_bf16_embed_scale_is_the_rounded_constant():
    cfg = get_config("gemma2-9b").replace(n_layers=2, vocab_size=8, d_ff=8,
                                          n_heads=1, n_kv_heads=1)
    model = LM(cfg, device="cpu")
    want = float(jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16))
    assert want == 59.75
    assert model.embed_scale.dtype == torch.bfloat16
    assert float(model.embed_scale) == want


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def smoke():
    """(port cfg, reference cfg, reference params as numpy, prompt, decode
    tokens) for gemma2-9b's smoke config."""
    cfg = get_config("gemma2-9b").smoke()
    j_cfg = j_get_config("gemma2-9b").smoke()
    params = jax.tree.map(np.asarray, j_lm.init(jax.random.PRNGKey(2), j_cfg))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (1, PROMPT))
    steps = rng.integers(0, cfg.vocab_size, (STEPS, 1, 1))
    return cfg, j_cfg, params, prompt, steps


def _reference_run(j_cfg, params, prompt, steps, impl):
    j_attention.set_attention_impl(impl)
    try:
        fwd, _, _ = j_lm.forward(params, j_cfg, jnp.asarray(prompt, jnp.int32))
        logits, caches, pos = j_lm.prefill(params, j_cfg,
                                           jnp.asarray(prompt, jnp.int32), MAX_LEN)
        prefill_caches = caches                   # jax arrays are immutable
        decode = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, j_cfg, t, c, q))
        dec = []
        for i, tok in enumerate(steps):
            out, caches = decode(params, jnp.asarray(tok, jnp.int32), caches,
                                 jnp.asarray(PROMPT + i, jnp.int32))
            dec.append(np.asarray(out))
    finally:
        j_attention.set_attention_impl("xla")

    def layer_order(c):
        P = j_cfg.pattern_len
        out = []
        for g in range(j_cfg.n_groups):
            for mi in range(P):
                out.append({k: np.asarray(c["groups"][mi][k][g]) for k in ("k", "v")})
        return out

    return {"forward": np.asarray(fwd), "prefill": np.asarray(logits),
            "pos": int(pos), "prefill_caches": layer_order(prefill_caches),
            "decode": dec, "decode_caches": layer_order(caches)}


@pytest.fixture(scope="module", params=["pallas", "xla"])
def reference(request, smoke):
    _, j_cfg, params, prompt, steps = smoke
    return _reference_run(j_cfg, params, prompt, steps, request.param)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_smoke_model_matches_reference(smoke, reference, impl):
    cfg, _, params, prompt, steps = smoke
    model = from_jax_params(cfg, params, device="cpu")
    attention.set_attention_impl(impl)
    try:
        fwd, caches, aux = model.forward(torch.from_numpy(prompt))
        np.testing.assert_allclose(fwd.detach().numpy(), reference["forward"],
                                   **MODEL_TOL)
        assert caches is None and float(aux) == 0.0
        logits, caches, pos = model.prefill(torch.from_numpy(prompt), MAX_LEN)
        assert pos.dtype == torch.int32 and pos.dim() == 0
        assert int(pos) == reference["pos"] == PROMPT
        np.testing.assert_allclose(logits.numpy(), reference["prefill"], **MODEL_TOL)
        sizes = [c["k"].shape[2] for c in caches]
        assert sizes == [16, MAX_LEN] * cfg.n_groups      # ring, full, ...
        for got, want in zip(caches, reference["prefill_caches"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(), want[key], **MODEL_TOL)
        for i, tok in enumerate(steps):
            out, caches2 = model.decode_step(torch.from_numpy(tok), caches, pos)
            assert caches2 is caches                      # written in place
            np.testing.assert_allclose(out.numpy(), reference["decode"][i],
                                       **MODEL_TOL)
            pos = pos + 1
        for got, want in zip(caches, reference["decode_caches"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(), want[key], **MODEL_TOL)
    finally:
        attention.set_attention_impl("kernel")


def test_extra_embeds_come_before_the_scaled_token_embeddings(smoke):
    """gemma2-9b ties its embeddings and scales the token rows by
    sqrt(d_model); extra_embeds (any config takes them) are put before the
    token rows unscaled, as the reference does, and prefill's position
    counts them."""
    cfg, j_cfg, params, prompt, _ = smoke
    extra = np.random.default_rng(9).standard_normal(
        (1, 5, cfg.d_model)).astype(np.float32) * 0.02
    want, _, _ = j_lm.forward(params, j_cfg, jnp.asarray(prompt, jnp.int32),
                              extra_embeds=jnp.asarray(extra))
    j_logits, _, j_pos = j_lm.prefill(params, j_cfg, jnp.asarray(prompt, jnp.int32),
                                      MAX_LEN, extra_embeds=jnp.asarray(extra))
    model = from_jax_params(cfg, params, device="cpu")
    with torch.no_grad():
        got, _, _ = model.forward(torch.from_numpy(prompt), extra_embeds=_t(extra))
    assert got.shape[1] == PROMPT + 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    logits, _, pos = model.prefill(torch.from_numpy(prompt), MAX_LEN,
                                   extra_embeds=_t(extra))
    assert int(pos) == int(j_pos) == PROMPT + 5
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **MODEL_TOL)


def test_from_jax_params_maps_every_leaf_once(smoke):
    cfg, _, params, _, _ = smoke
    model = from_jax_params(cfg, params, device="cpu")
    j_leaves = jax.tree.leaves(params)
    assert sum(a.size for a in j_leaves) == sum(p.numel() for p in model.parameters())
    flat = jax_leaf_names(cfg, params)
    assert set(flat) == {n for n, _ in model.named_parameters()}
    per_layer = len(flat) - 2                          # embed, final_norm.scale
    assert per_layer == cfg.n_layers * 11              # 4 norms, q k v o, wi wg wo
    for name, p in model.named_parameters():
        want = np.asarray(flat[name], np.float32)
        np.testing.assert_array_equal(p.detach().float().numpy(), want)
    assert model.layers[0].kind == "local" and model.layers[1].kind == "attn"
    np.testing.assert_array_equal(model.layers[3].attn["q"].detach().numpy(),
                                  params["groups"][1]["attn"]["q"][1])


def test_from_jax_params_rejects_extra_and_missing_leaves(smoke):
    cfg, _, params, _, _ = smoke
    extra = {**params, "lm_head": np.zeros((cfg.d_model, cfg.vocab_size), np.float32)}
    with pytest.raises(ValueError, match="without a port parameter"):
        from_jax_params(cfg, extra, device="cpu")
    missing = {**params, "final_norm": {}}
    with pytest.raises(ValueError, match="without a reference leaf"):
        from_jax_params(cfg, missing, device="cpu")


def test_bf16_weights_are_cast_once_at_load(smoke):
    cfg, _, params, _, _ = smoke
    model = from_jax_params(cfg, params, device="cpu", dtype=torch.bfloat16)
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].attn["q"].dtype == torch.bfloat16
    assert model.layers[0].ln1["scale"].dtype == torch.float32
    want = np.asarray(jnp.asarray(params["embed"]).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(model.embed.detach().float().numpy(), want)


def test_init_scales_and_seed():
    cfg = get_config("gemma2-9b").smoke().replace(vocab_size=4096)
    a = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    d, ff = cfg.d_model, cfg.d_ff
    std = {"embed": d ** -0.5, "layers.0.attn.q": d ** -0.5,
           "layers.0.attn.o": (cfg.n_heads * cfg.head_dim) ** -0.5,
           "layers.1.mlp.wo": ff ** -0.5, "layers.1.mlp.wg": d ** -0.5}
    params = dict(a.named_parameters())
    for name, s in std.items():
        assert abs(params[name].std().item() / s - 1.0) < 0.1, name
    assert torch.equal(params["layers.0.post2.scale"], torch.ones(d))


def test_unported_families_raise_naming_the_roadmap():
    # every family of the reference is ported: the ten configs resolve and
    # build; what a config can still ask for and not get is the MoE's
    # shard_map dispatch, which waits for the mesh (ROADMAP.md item 18)
    for arch in ("deepseek-moe-16b", "moonshot-v1-16b-a3b", "mamba2-130m",
                 "recurrentgemma-9b", "seamless-m4t-large-v2"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        set_flags(OptFlags(moe_impl="shardmap"))
    with pytest.raises(ValueError, match="EncDec"):
        LM(get_config("seamless-m4t-large-v2").smoke(), device="cpu")


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_config("gemma2-9b").smoke())
