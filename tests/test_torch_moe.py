"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the CPU.

The reference's own parameters (``init_moe``) and numpy inputs made from a
seed go through both ``apply_moe`` s, held at 1e-5 with both dispatches
(``"einsum"``, ``"gather"``) and at capacity factors 8 (dropless), 1.25 and
0.5, where the same assignments drop.  Then the twins of
``tests/test_moe.py`` (routing, capacity, aux loss; its hypothesis property
as a few fixed shapes) and of ``tests/test_opt_equivalence.py:23-57``
(gather == einsum, outputs, aux and gradients), and a constructed router
tie that pins ``lax.top_k``'s lower-index rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe
from repro.models.opt_flags import OptFlags as JFlags
from repro.models.opt_flags import clear_flags as j_clear_flags
from repro.models.opt_flags import set_flags as j_set_flags
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.opt_flags import OptFlags, clear_flags, set_flags

CFG = get_config("deepseek-moe-16b").smoke()
J_CFG = j_get_config("deepseek-moe-16b").smoke()
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_flags():
    clear_flags()
    j_clear_flags()
    yield
    clear_flags()
    j_clear_flags()


def _params(seed=0):
    return jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(seed), J_CFG))


def _torch_tree(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, requires_grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), requires_grad=requires_grad)


def _x(B, S, seed=1, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, CFG.d_model)) * scale).astype(np.float32)


def _setup(seed=0, B=2, S=16):
    return _torch_tree(_params(seed)), torch.from_numpy(_x(B, S, seed + 1))


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_apply_moe_matches_reference(impl, cf):
    cfg, j_cfg = CFG.replace(moe_capacity_factor=cf), J_CFG.replace(moe_capacity_factor=cf)
    params, x = _params(3), _x(2, 32, 4)
    set_flags(OptFlags(moe_impl=impl))
    j_set_flags(JFlags(moe_impl=impl))
    y, aux = moe.apply_moe(_torch_tree(params), torch.from_numpy(x), cfg)
    y_ref, aux_ref = j_moe.apply_moe(params, jnp.asarray(x), j_cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    if cf == 0.5:
        # the capacity binds: some assignments drop, the same ones as the
        # reference's (the outputs above agree), so dropless differs
        free, _ = moe.apply_moe(_torch_tree(params), torch.from_numpy(x),
                                cfg.replace(moe_capacity_factor=8.0))
        assert not np.allclose(y.numpy(), free.numpy(), atol=1e-5)


def test_routing_tables_match_reference_drop_set():
    # the kept assignments at cf 0.5 are the reference's keep mask
    params, x = _params(3), _x(2, 32, 4)
    xt = x.reshape(-1, CFG.d_model)
    probs = torch.softmax(torch.from_numpy(xt) @ torch.tensor(params["router"]), -1)
    T, E, K = xt.shape[0], CFG.n_experts, CFG.moe_top_k
    C = moe.capacity_of(CFG.replace(moe_capacity_factor=0.5), T)
    _, idx, pos_sel, keep_sel, _ = moe.route(probs, K, C)
    j_probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(params["router"]), -1)
    _, j_idx = jax.lax.top_k(j_probs, K)
    onehot = jax.nn.one_hot(j_idx, E, dtype=jnp.int32)
    position = jnp.cumsum(onehot.transpose(1, 0, 2).reshape(K * T, E), 0) - 1
    keep = (position < C) & (onehot.transpose(1, 0, 2).reshape(K * T, E) > 0)
    j_keep = np.asarray(keep.reshape(K, T, E).any(-1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(keep_sel.numpy(), j_keep)
    assert 0 < int((~keep_sel).sum()) < K * T


def test_router_ties_go_to_the_lower_index():
    # experts 2, 5 and 7 share one router column of small integers and x is
    # integer-valued, so their logits are equal exactly and the largest:
    # lax.top_k takes 2 and 5, in that order, and so must the port
    d, E = CFG.d_model, CFG.n_experts
    rng = np.random.default_rng(0)
    router = np.zeros((d, E), np.float32)
    router[:, [2, 5, 7]] = rng.integers(1, 3, d)[:, None]
    params = _params()
    params["router"] = router
    x = rng.integers(0, 2, (1, 6, d)).astype(np.float32)
    x[0, :, 0] = 1.0
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, d) @ router), -1)
    assert torch.equal(probs[:, 2], probs[:, 7]) and torch.equal(probs[:, 2], probs[:, 5])
    gates, idx = moe.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), [[2, 5]] * 6)
    j_gates, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(gates.numpy(), np.asarray(j_gates))
    y, _ = moe.apply_moe(_torch_tree(params), torch.from_numpy(x), CFG)
    y_ref, _ = j_moe.apply_moe(params, jnp.asarray(x), J_CFG)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)


# ---------------------------------------------------- twins of tests/test_moe.py

def test_output_shape_and_finite():
    params, x = _setup()
    y, aux = moe.apply_moe(params, x, CFG)
    assert y.shape == x.shape
    assert torch.isfinite(y).all() and torch.isfinite(aux)


def test_aux_loss_lower_bound():
    """The Switch aux loss is at least 1 (its value for uniform routing)."""
    params, x = _setup()
    _, aux = moe.apply_moe(params, x, CFG)
    assert float(aux) >= 1.0 - 1e-3


def test_dropless_capacity_is_length_independent():
    params, x = _setup(B=1, S=12)
    y_full, _ = moe.apply_moe(params, x, CFG, capacity=12)
    y_short, _ = moe.apply_moe(params, x[:, :8], CFG, capacity=8)
    np.testing.assert_allclose(y_full[:, :8].numpy(), y_short.numpy(), rtol=1e-5, atol=1e-6)


def test_tiny_capacity_drops_tokens():
    params, x = _setup(B=2, S=32)
    y_drop, _ = moe.apply_moe(params, x, CFG, capacity=1)
    y_free, _ = moe.apply_moe(params, x, CFG, capacity=64)
    assert not np.allclose(y_drop.numpy(), y_free.numpy(), atol=1e-5)


def test_priority_is_token_order():
    """At capacity 1 the first token claiming an expert keeps its slot: a
    twin put in front takes the later copy's slots, never the first's."""
    params, x = _setup(B=1, S=8)
    y, _ = moe.apply_moe(params, x, CFG, capacity=1)
    y2, _ = moe.apply_moe(params, torch.cat([x[:, :1], x], dim=1), CFG, capacity=1)
    np.testing.assert_allclose(y2[:, 0].numpy(), y[:, 0].numpy(), rtol=1e-5, atol=1e-6)


def test_shared_expert_always_on():
    params, x = _setup()
    assert "shared" in params
    y, _ = moe.apply_moe(params, x, CFG, capacity=1)
    assert float(y.abs().max()) > 0


@pytest.mark.parametrize("b,s", [(1, 1), (1, 24), (3, 7), (4, 13)])
def test_moe_shapes(b, s):
    params = _torch_tree(_params())
    x = torch.from_numpy(_x(b, s, 1, 0.3))
    y, aux = moe.apply_moe(params, x, CFG)
    assert y.shape == (b, s, CFG.d_model)
    assert torch.isfinite(y).all() and torch.isfinite(aux)


# ------------------------------- twins of tests/test_opt_equivalence.py:23-57

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0])
def test_moe_gather_equals_einsum(capacity_factor):
    cfg = CFG.replace(moe_capacity_factor=capacity_factor)
    params, x = _torch_tree(_params()), torch.from_numpy(_x(2, 32, 1, 1.0))
    y1, a1 = moe.apply_moe(params, x, cfg)
    set_flags(OptFlags(moe_impl="gather"))
    y2, a2 = moe.apply_moe(params, x, cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    assert float(a1) == float(a2)


def test_moe_gather_grads_match():
    x = torch.from_numpy(_x(1, 32, 1, 1.0))
    grads = {}
    for impl in ("einsum", "gather"):
        set_flags(OptFlags(moe_impl=impl))
        params = _torch_tree(_params(), requires_grad=True)
        y, aux = moe.apply_moe(params, x, CFG)
        leaves = [params["router"], *params["experts"].values(), *params["shared"].values()]
        grads[impl] = torch.autograd.grad((y ** 2).sum() + aux, leaves)
    for a, b in zip(grads["einsum"], grads["gather"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_moe_grads_match_reference():
    params, x = _params(), _x(1, 32, 1, 1.0)

    def j_loss(p):
        y, aux = j_moe.apply_moe(p, jnp.asarray(x), J_CFG)
        return (y ** 2).sum() + aux

    j_grads = jax.jit(jax.grad(j_loss))(jax.tree.map(jnp.asarray, params))
    tp = _torch_tree(params, requires_grad=True)
    y, aux = moe.apply_moe(tp, torch.from_numpy(x), CFG)
    got = torch.autograd.grad((y ** 2).sum() + aux, [tp["router"], tp["experts"]["wo"]])
    for g, want in zip(got, (j_grads["router"], j_grads["experts"]["wo"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_set_flags_takes_both_dispatches_and_refuses_shardmap():
    for impl in ("einsum", "gather"):
        set_flags(OptFlags(moe_impl=impl))
    with pytest.raises(ValueError, match="item 18"):
        set_flags(OptFlags(moe_impl="shardmap"))
