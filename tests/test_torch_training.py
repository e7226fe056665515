"""Training in the port (the reference's ``make_train_step`` path) against
the JAX package, on the CPU, and the token pipeline and profile hook it
uses.

* ``LM.loss_fn`` against ``lm.loss_fn``: both ``sharded_loss`` forms, a
  mask, internvl2-26b's ``extra_embeds`` (their logits dropped), value and
  every gradient;
* the flash wrapper's ``autograd.Function`` (kernel forward, a plain
  PyTorch backward in blocks of query rows) against the reference's
  ``flash_attention`` with its Pallas forward in interpret mode, as
  ``tests/test_kernels.py:86-96`` runs it, at 1e-4 in fp32 (the kernels'
  types);
* that backward against autodiff through the plain version over many
  query blocks, and the score elements it counts as computed and skipped;
* ``flash_attention_chunked`` (``OptFlags.flash_bwd``) against autodiff and
  against the reference's ``flash_attention_xla`` (the twins of
  ``tests/test_opt_equivalence.py:59`` and ``:81``);
* ``make_train_step`` against the reference's after 2 AdamW steps at 1 and
  2 microbatches: the losses at rtol 1e-5; every updated parameter within
  a tenth of the learning rate (atol 1e-4 at a rate of 1e-3), and all but
  0.1 % of the elements within 1e-6.  Adam's first steps normalise each
  gradient element, so an element whose gradient is near ``eps`` (1e-8)
  moves by an amount that rounding changes: on the smoke configs a handful
  of ~10^5 elements differ by up to 8 % of the rate;
* ``accumulate_grads``' fp32 gradients at 2 and 4 microbatches against 1;
* ``set_flags`` refuses a flag the port does not read, and takes
  ``cache_update="inplace"``, under which a decode step's logits and caches
  equal the default's bit for bit;
* ``TokenPipeline`` batches and checksums bit for bit;
* ``profile_capture`` writes a ``torch.profiler`` trace under an obs span,
  and a train step shows the profiler ranges that attribute its time.

Model tests run the reference's smoke configs, which are fp32.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.kernels import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.launch import steps as j_steps
from repro.models import lm as j_lm
from repro.models import opt_flags as j_flags
from repro.models.attention import chunked_attention as j_chunked
from repro.models.attention import flash_attention_xla as j_flash_xla
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import (bwd_block_rows, chunked_backward,
                                                 flash_attention_torch)
from repro_torch.launch import steps
from repro_torch.models import attention
from repro_torch.models import opt_flags
from repro_torch.models.weights import from_jax_params, init
from repro_torch.obs import observe, profile_capture
from repro_torch.optim import AdamWConfig, adamw_init


LR = 1e-3


@pytest.fixture(autouse=True)
def _clean_flags():
    opt_flags.clear_flags()
    j_flags.clear_flags()
    attention.set_attention_impl("kernel")
    yield
    opt_flags.clear_flags()
    j_flags.clear_flags()
    attention.set_attention_impl("kernel")


def _both_flags(**kw):
    opt_flags.set_flags(opt_flags.OptFlags(**kw))
    j_flags.set_flags(j_flags.OptFlags(**kw))


def _ref_model(name, seed=0):
    cfg, j_cfg = get_config(name).smoke(), j_get_config(name).smoke()
    params = jax.tree.map(np.asarray, j_lm.init(jax.random.PRNGKey(seed), j_cfg))
    return cfg, j_cfg, params


def _batch(cfg, rows=4, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    mask = (rng.random((rows, seq)) > 0.2).astype(np.float32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    if cfg.frontend == "vision":
        batch["extra_embeds"] = (rng.standard_normal((rows, 3, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return batch


def _flat_ref_grads(cfg, grads):
    from repro_torch.models.weights import jax_leaf_names

    return {k: np.asarray(v) for k, v in jax_leaf_names(cfg, grads).items()}


# ------------------------------------------------------------------ loss_fn

@pytest.mark.parametrize("sharded", [False, True], ids=["logsumexp", "sharded"])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "internvl2-26b", "gemma2-9b"])
def test_loss_fn_and_gradients_match_reference(name, sharded):
    cfg, j_cfg, params = _ref_model(name)
    batch = _batch(cfg)
    _both_flags(sharded_loss=sharded)
    (j_total, j_metrics), j_grads = jax.value_and_grad(
        lambda p: j_lm.loss_fn(p, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    model = from_jax_params(cfg, params, device="cpu")
    total, metrics = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    for key in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]),
                                   rtol=1e-5, atol=1e-7)
    assert float(metrics["tokens"]) == float(batch["mask"].sum())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()))
    want = _flat_ref_grads(cfg, j_grads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n], rtol=2e-3, atol=1e-6,
                                   err_msg=n)


def test_remat_changes_no_number():
    cfg = get_config("granite-3-8b").smoke()
    model = init(cfg, torch.Generator().manual_seed(3), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    for remat in (False, True):
        total, _ = model.loss_fn(batch, remat=remat)
        out[remat] = (total, *torch.autograd.grad(total, list(model.parameters())))
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_fp32_master_weights_cast_at_use_equal_weights_cast_at_load():
    """A bf16 model with fp32 master weights computes what the same seed's
    bf16-stored model computes, and its gradients are fp32."""
    cfg = get_config("stablelm-1.6b").smoke().replace(dtype="bfloat16")
    served = init(cfg, torch.Generator().manual_seed(5), device="cpu")
    master = init(cfg, torch.Generator().manual_seed(5), device="cpu",
                  param_dtype=torch.float32)
    assert served.embed.dtype == torch.bfloat16 and master.embed.dtype == torch.float32
    assert master.layers[0].mlp["wi"].dtype == torch.float32
    for (n, a), (_, b) in zip(served.named_parameters(), master.named_parameters()):
        assert torch.equal(a, b.to(a.dtype)), n
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        a, _, _ = served.forward(batch["inputs"])
        b, _, _ = master.forward(batch["inputs"])
    assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    total, _ = master.loss_fn(batch)
    grads = torch.autograd.grad(total, list(master.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


# ------------------------------------------------------------------ flash grads

FLASH_GRAD_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window, cap, q_offset)
    (1, 2, 1, 128, 128, 64, True, None, None, 0),
    (1, 4, 2, 64, 128, 32, True, 48, 30.0, 64),
    (2, 2, 2, 40, 40, 16, False, None, 50.0, 0),
]


@pytest.mark.parametrize("shape", FLASH_GRAD_CASES)
def test_flash_function_gradients_match_reference(shape):
    B, H, KV, Sq, Sk, hd, causal, window, cap, off = shape
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    bq, bk = min(128, max(8, Sq)), min(128, max(8, Sk))

    def j_loss(q, k, v):
        return (j_flash(q, k, v, causal, window, cap, off, bq, bk) ** 2).sum()

    def j_loss_ref(q, k, v):
        return (j_flash_ref(q, k, v, causal=causal, window=window,
                            logit_cap=cap, q_offset=off) ** 2).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    want_ref = jax.grad(j_loss_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off)
    for fn in (flash_attention, flash_attention_torch):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        out = fn(tq, tk, tv, **kw)
        got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
        for g, w, wr in zip(got, want, want_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=1e-4, atol=1e-4)


def test_flash_function_forward_is_one_call_and_backward_no_kernel():
    q, k, v = (torch.randn(s, generator=torch.Generator().manual_seed(1))
               .requires_grad_(True) for s in ((1, 2, 16, 16), (1, 1, 16, 16),
                                               (1, 1, 16, 16)))
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    with torch.no_grad():
        plain = flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


@pytest.mark.parametrize("shape", [
    # (B, H, KV, Sq, Sk, hd, causal, window, cap, q_offset, k_len, block)
    (1, 4, 2, 96, 160, 32, True, None, None, 64, None, 32),
    (2, 3, 1, 40, 40, 16, False, None, 50.0, 0, 29, 16),
    # a window past k_len: the last rows see no key, their output is 0 and
    # they pass no gradient
    (1, 2, 2, 64, 64, 16, True, 8, None, 0, 40, 16),
    # causal, Sq not a multiple of the block
    (1, 2, 2, 100, 100, 16, True, None, None, 0, None, 32),
    # a window narrower than a block
    (1, 2, 1, 80, 80, 16, True, 8, None, 0, None, 32),
    # G 9: nine heads share each block's K and V
    (1, 9, 1, 70, 70, 8, True, None, None, 0, None, 32),
    # a causal softcap
    (1, 4, 2, 72, 72, 16, True, None, 30.0, 0, None, 24),
    # a window without causal, past a q_offset and inside k_len
    (1, 2, 1, 50, 80, 8, False, 6, None, 10, 70, 16),
])
def test_flash_function_backward_equals_autodiff_through_plain(shape):
    """The backward in blocks of query rows (the default block through the
    wrapper, and several blocks here) is the gradient of the plain version,
    masks and ``k_len`` included."""
    B, H, KV, Sq, Sk, hd, causal, window, cap, off, k_len, block = shape
    rng = np.random.default_rng(9)
    arrs = [rng.standard_normal(s) for s in ((B, H, Sq, hd), (B, KV, Sk, hd),
                                             (B, KV, Sk, hd), (B, H, Sq, hd))]
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off, k_len=k_len)
    q, k, v = (torch.tensor(a, dtype=torch.float32, requires_grad=True)
               for a in arrs[:3])
    dout = torch.tensor(arrs[3], dtype=torch.float32)
    want = torch.autograd.grad(flash_attention_torch(q, k, v, **kw), (q, k, v), dout)
    got = torch.autograd.grad(flash_attention(q, k, v, **kw), (q, k, v), dout)
    small = chunked_backward(q, k, v, dout, block=block, **kw)
    for a, b, c in zip(got, small, want):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(b, c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,window,block,share", [
    (True, None, 512, 5 / 8),   # blocks see 512, 1,024, 1,536, 2,048 keys
    (True, None, None, 9 / 16),     # the default at train-2k: 8 blocks of 256
    (False, None, 512, 1.0),
    (True, 100, 512, (512 + 3 * (512 + 99)) / 2048 / 4),     # each block's band
])
def test_flash_backward_counts_the_scores_it_computes(causal, window, block, share):
    """At train-2k's causal S 2,048 in blocks of 512, 5/8 of the score
    elements are computed, and 9/16 in the blocks of 256 that the default
    gives at its B 4 and H 32; a non-causal call computes them all, a
    windowed one only its band."""
    assert bwd_block_rows(4, 32, 2048) == 256
    g = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn((1, 1, 2048, 8), generator=g) for _ in range(4))
    block = block or bwd_block_rows(4, 32, 2048)
    with observe() as ob:
        chunked_backward(q, k, v, dout, causal=causal, window=window, block=block)
    counts = ob.registry.snapshot()
    done = counts["flash_attention.bwd_scores_computed"]
    assert done == share * 2048 * 2048
    assert done + counts["flash_attention.bwd_scores_skipped"] == 2048 * 2048


@pytest.mark.parametrize(
    "causal,window,cap,off",
    [(True, None, None, 0), (True, 64, 50.0, 0), (False, None, None, 0),
     (True, None, 30.0, 128), (True, 32, None, 64)],
)
def test_flash_bwd_matches_autodiff(causal, window, cap, off):
    """The twin of tests/test_opt_equivalence.py:59, held to the port's
    autodiff through chunked_attention and to the reference's custom VJP.
    Its backward runs under the kernel path's ``flash_attention.backward``
    range, once a call."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 128, 32), (1, 2, 192, 32), (1, 2, 192, 32)))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=off)

    def t_loss(fn, **extra):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        val = (fn(tq, tk, tv, **kw, **extra) ** 2).sum()
        return val, torch.autograd.grad(val, (tq, tk, tv))

    ref_val, ref_g = t_loss(attention.chunked_attention, chunk=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        new_val, new_g = t_loss(attention.flash_attention_chunked)
    assert [e.name for e in prof.events()].count("flash_attention.backward") == 1
    np.testing.assert_allclose(float(new_val), float(ref_val), rtol=1e-5)
    for a, b in zip(new_g, ref_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)

    def j_new(q, k, v):
        return (j_flash_xla(q, k, v, causal, window, cap, off) ** 2).sum()

    j_g = jax.grad(j_new, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(float(new_val), float(j_new(q, k, v)), rtol=1e-5)
    for a, b in zip(new_g, j_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_sharded_loss_and_flash_bwd_full_model():
    """The twin of tests/test_opt_equivalence.py:81: loss and every gradient
    the same with the flags on, on the plain attention (the ``flash_bwd``
    path), and equal to the reference's with the same flags."""
    cfg, j_cfg, params = _ref_model("gemma2-9b")
    rng = np.random.default_rng(1)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)}
    model = from_jax_params(cfg, params, device="cpu")
    attention.set_attention_impl("torch")
    out = {}
    for on in (False, True):
        _both_flags(sharded_loss=on, flash_bwd=on)
        total, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
        out[on] = (total, torch.autograd.grad(total, list(model.parameters())))
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]), rtol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=1e-5)
    j_val, j_grads = jax.value_and_grad(lambda p: j_lm.loss_fn(
        p, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()})[0])(params)
    np.testing.assert_allclose(float(out[True][0]), float(j_val), rtol=1e-5)
    want = _flat_ref_grads(cfg, j_grads)
    for (n, _), g in zip(model.named_parameters(), out[True][1]):
        np.testing.assert_allclose(g.numpy(), want[n], rtol=2e-3, atol=1e-6, err_msg=n)


# ------------------------------------------------------------------ train step

@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "internvl2-26b"])
def test_train_step_matches_reference_after_two_steps(name, n_micro):
    cfg, j_cfg, params = _ref_model(name, seed=2)
    opt = dict(peak_lr=LR, warmup_steps=1, total_steps=10)
    j_step = jax.jit(j_steps.make_train_step(j_cfg, JAdamWConfig(**opt), n_micro))
    j_params, j_state = params, j_adamw_init(params)
    model = from_jax_params(cfg, params, device="cpu", param_dtype=torch.float32)
    step = steps.make_train_step(cfg, AdamWConfig(**opt), n_micro)
    state = adamw_init(dict(model.named_parameters()))
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                        global_batch=4, seed=3))
    for i in range(2):
        batch = pipe.batch(i)
        if cfg.frontend == "vision":
            batch["extra_embeds"] = _batch(cfg, seed=i)["extra_embeds"]
        j_params, j_state, j_metrics = j_step(
            j_params, j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        model, state, metrics = step(model, state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(j_metrics["grad_norm"]), rtol=1e-4)
    assert int(state["count"]) == 2
    want = _flat_ref_grads(cfg, jax.tree.map(np.asarray, j_params))
    loose = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32
        diff = np.abs(p.detach().numpy() - want[n])
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5,
                                   atol=LR / 10, err_msg=n)
        loose += int((diff > 1e-6).sum())
    # all but a handful of elements (a gradient near Adam's eps makes
    # g / (|g| + eps) sensitive to rounding) agree to 1e-6
    assert loose <= 1e-3 * sum(p.numel() for p in model.parameters()), loose


def test_microbatches_accumulate_to_the_full_batch_step():
    cfg = get_config("granite-3-8b").smoke()
    batch = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         global_batch=4, seed=4)).batch(0)
    batch["mask"][:] = 1.0
    out = {}
    for n in (1, 2, 4):
        model = init(cfg, torch.Generator().manual_seed(6), device="cpu",
                     param_dtype=torch.float32)
        state = adamw_init(dict(model.named_parameters()))
        model, state, metrics = steps.make_train_step(cfg, AdamWConfig(), n)(
            model, state, batch)
        out[n] = (metrics, dict(model.named_parameters()))
    for n in (2, 4):
        np.testing.assert_allclose(float(out[n][0]["loss"]), float(out[1][0]["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(out[n][0]["grad_norm"]),
                                   float(out[1][0]["grad_norm"]), rtol=1e-5)
        for k, p in out[n][1].items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       out[1][1][k].detach().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    model = init(cfg, torch.Generator().manual_seed(6), device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(cfg, AdamWConfig(), 3)(
            model, adamw_init(dict(model.named_parameters())), batch)


def test_accumulated_gradients_of_microbatches_equal_the_full_batch():
    """The fp32 gradients before the update, where Adam's normalisation does
    not amplify rounding: 2 and 4 microbatches against 1."""
    cfg = get_config("stablelm-1.6b").smoke()
    batch = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         global_batch=4, seed=5)).batch(0)
    model = init(cfg, torch.Generator().manual_seed(7), device="cpu",
                 param_dtype=torch.float32)
    out = {n: steps.accumulate_grads(model, batch, n) for n in (1, 2, 4)}
    names = [k for k, _ in model.named_parameters()]
    for n in (1, 2, 4):
        assert list(out[n][0]) == names
        assert all(g.dtype == torch.float32 for g in out[n][0].values())
    for n in (2, 4):
        torch.testing.assert_close(out[n][1], out[1][1], rtol=1e-6, atol=0.0)
        for k in names:
            want = out[1][0][k]
            torch.testing.assert_close(out[n][0][k], want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()), msg=k)


@pytest.mark.parametrize("field,value", [("moe_impl", "no-such-dispatch"),
                                         ("bf16_collectives", True),
                                         ("cache_update", "no-such-update")])
def test_set_flags_refuses_a_flag_the_port_does_not_read(field, value):
    with pytest.raises(ValueError, match=field):
        opt_flags.set_flags(opt_flags.OptFlags(**{field: value}))
    assert opt_flags.get_flags() == opt_flags.OptFlags()
    j_flags.set_flags(j_flags.OptFlags(**{field: value}))   # the reference takes it


def test_set_flags_takes_cache_update_which_the_port_does_in_place():
    for value in ("inplace", "stream"):
        opt_flags.set_flags(opt_flags.OptFlags(cache_update=value))
        assert opt_flags.get_flags().cache_update == value
        opt_flags.clear_flags()
    assert "cache_update" in opt_flags.READ and "cache_update" not in opt_flags.WAITS


@pytest.mark.parametrize("name", ["gemma2-9b", "deepseek-moe-16b"])
def test_decode_under_inplace_cache_equals_stream(name):
    """The reference's cache_update="inplace" moves its caches into a scan's
    carry; the port's decode step writes them in place either way, so the
    flag changes no bit of its logits or caches."""
    cfg = get_config(name).smoke()
    model = init(cfg, torch.Generator().manual_seed(5), device="cpu",
                 param_dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 1)))
    runs = []
    for value in ("stream", "inplace"):
        opt_flags.set_flags(opt_flags.OptFlags(cache_update=value))
        out = steps.make_prefill_step(cfg, max_len=16)(model, {"inputs": prompt})
        logits, caches, pos = [out["logits"]], out["caches"], out["pos"]
        for tok in toks:
            out = steps.make_decode_step(cfg)(model, {"token": tok, "caches": caches,
                                                      "pos": pos})
            logits.append(out["logits"])
            caches, pos = out["caches"], pos + 1
        runs.append((logits, caches))
        opt_flags.clear_flags()
    (la, ca), (lb, cb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    flat_a, flat_b = (torch.utils._pytree.tree_flatten(c)[0] for c in (ca, cb))
    assert len(flat_a) == len(flat_b) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))


def test_set_flags_takes_mesh_factor_which_the_dry_run_reads():
    flags = opt_flags.OptFlags(mesh_factor=(64, 4))
    opt_flags.set_flags(flags)
    try:
        assert opt_flags.get_flags().mesh_factor == (64, 4)
    finally:
        opt_flags.clear_flags()
    assert "mesh_factor" in opt_flags.READ and "mesh_factor" not in opt_flags.WAITS


@pytest.mark.parametrize("gb,seq,dp", [(8, 2048, 1), (256, 4096, 16), (4, 16, 1),
                                       (32, 8192, 2), (6, 4096, 1), (1, 100_000, 1)])
def test_pick_microbatches_matches_reference(gb, seq, dp):
    assert steps.pick_microbatches(gb, seq, dp) == j_steps.pick_microbatches(gb, seq, dp)
    assert steps.micro_depth(gb, seq, dp) == j_steps.pick_microbatches(gb, seq, dp)
    opt_flags.set_flags(opt_flags.OptFlags(n_micro_override=32))
    assert steps.micro_depth(gb, seq, dp) == 32
    assert steps.pick_microbatches(8, 2048, 1) == 2


# ------------------------------------------------------------------ pipeline

@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=200, global_batch=4),
    dict(vocab_size=100_352, seq_len=2048, global_batch=8, seed=7),
    dict(vocab_size=49_152, seq_len=97 * 3, global_batch=8, seed=1, num_hosts=4,
         host_index=2),
])
def test_token_pipeline_bit_for_bit(kw):
    ours, ref = TokenPipeline(PipelineConfig(**kw)), JTokenPipeline(JPipelineConfig(**kw))
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        assert set(a) == set(b) == {"inputs", "targets", "mask"}
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        assert ours.global_batch_checksum(step) == ref.global_batch_checksum(step)


# ------------------------------------------------------------------ profile hook

def test_profile_capture_writes_a_trace_under_a_span(tmp_path):
    logdir = str(tmp_path / "prof")
    with observe() as ob:
        with profile_capture(logdir):
            torch.ones(64).mul(2.0).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(logdir, files[0])) as f:
        trace = json.load(f)
    assert any("mul" in e.get("name", "") for e in trace["traceEvents"])
    spans = [e for e in ob.tracer.events() if e.get("name") == "torch.profiler.capture"]
    assert [e["ph"] for e in spans] == ["B", "E"]
    assert spans[0]["args"]["logdir"] == logdir


def test_train_step_profile_ranges():
    """The ranges a profiled step is attributed by: each microbatch's
    forward and backward, each layer's run under remat (again in the
    backward: the recomputation) and the flash backward."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("stablelm-1.6b").smoke()
    model = init(cfg, torch.Generator().manual_seed(1), device="cpu",
                 param_dtype=torch.float32)
    batch = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         global_batch=4, seed=2)).batch(0)
    step = steps.make_train_step(cfg, AdamWConfig(), 2)
    state = adamw_init(dict(model.named_parameters()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, state, batch)
    names = [e.name for e in prof.events()]
    L = cfg.n_layers
    assert names.count("train_step.forward") == names.count("train_step.backward") == 2
    assert names.count("lm.layer") == 2 * 2 * L
    assert names.count("flash_attention.backward") == 2 * L
