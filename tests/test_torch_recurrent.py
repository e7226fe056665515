"""The port's recurrent blocks against the JAX package's on the CPU: the
Mamba-2 SSD block (``repro_torch.models.ssm``) and the RG-LRU block
(``repro_torch.models.rglru``).

The reference's own parameters (``init_ssm``, ``init_rglru``) and numpy
inputs made from a seed go through both prefills and decodes, held at 1e-5:
sequence lengths off the chunk size (the padding) and shorter than the conv
width less one (the conv cache's zero rows), the final states (h and the
conv cache), and decode steps continued from them.  The doubling scan is
held to the sequential recurrence, and the SSD prefill's gradients stay
finite (its decay exponent is masked before ``exp``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
from repro_torch.configs import get_config
from repro_torch.models import rglru, ssm

TOL = dict(rtol=1e-5, atol=1e-5)
SSM = get_config("mamba2-130m").smoke()
J_SSM = j_get_config("mamba2-130m").smoke()
RG = get_config("recurrentgemma-9b").smoke()
J_RG = j_get_config("recurrentgemma-9b").smoke()
# the reference jitted: compiling once beats running it op by op
_J_SSM_DECODE = jax.jit(lambda p, x, st: j_ssm.ssm_decode(p, x, st, J_SSM))
_J_RG_DECODE = jax.jit(lambda p, x, st: j_rglru.rglru_decode(p, x, st, J_RG))


def _torch_tree(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, requires_grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), requires_grad=requires_grad)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def ssm_params():
    p = jax.tree.map(np.asarray, j_ssm.init_ssm(jax.random.PRNGKey(1), J_SSM))
    # a random A and D, so the decay differs per head
    rng = np.random.default_rng(2)
    p["A_log"] = rng.standard_normal(p["A_log"].shape).astype(np.float32) * 0.5
    p["D"] = rng.standard_normal(p["D"].shape).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def rg_params():
    p = jax.tree.map(np.asarray, j_rglru.init_rglru(jax.random.PRNGKey(3), J_RG))
    p["ba"] = np.random.default_rng(4).standard_normal(p["ba"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 16), (2, 16), (3, 128), (1, 8)])
def test_ssm_prefill_and_decode_match_reference(ssm_params, S, chunk):
    x = _x(2, S + 3, SSM.d_model, S)
    y, st = ssm.ssm_prefill(_torch_tree(ssm_params), torch.from_numpy(x[:, :S]), SSM,
                            chunk=chunk)
    y_ref, st_ref = jax.jit(lambda p, x: j_ssm.ssm_prefill(p, x, J_SSM, chunk=chunk))(
        ssm_params, jnp.asarray(x[:, :S]))
    _close(y, y_ref)
    _close(st["h"], st_ref["h"])
    _close(st["conv"], st_ref["conv"])
    assert st["h"].dtype == torch.float32
    for i in range(S, S + 3):
        y, st = ssm.ssm_decode(_torch_tree(ssm_params), torch.from_numpy(x[:, i:i + 1]),
                               st, SSM)
        y_ref, st_ref = _J_SSM_DECODE(ssm_params, jnp.asarray(x[:, i:i + 1]), st_ref)
        _close(y, y_ref)
        _close(st["h"], st_ref["h"])
        _close(st["conv"], st_ref["conv"])


def test_ssm_prefill_equals_decoding_token_by_token(ssm_params):
    x = torch.from_numpy(_x(1, 20, SSM.d_model, 9))
    p = _torch_tree(ssm_params)
    y, _ = ssm.ssm_prefill(p, x, SSM, chunk=8)
    st = ssm.init_ssm_state(SSM, 1, torch.float32, "cpu")
    for i in range(20):
        yi, st = ssm.ssm_decode(p, x[:, i:i + 1], st, SSM)
        np.testing.assert_allclose(yi[:, 0].numpy(), y[:, i].numpy(), rtol=1e-4, atol=1e-5)


def test_ssm_prefill_gradients_are_finite(ssm_params):
    # a strong decay makes exp(cum_i - cum_j) above the diagonal overflow
    p = _torch_tree(ssm_params, requires_grad=True)
    with torch.no_grad():
        p["A_log"].fill_(4.0)
        p["dt_bias"].fill_(4.0)
    x = torch.from_numpy(_x(1, 40, SSM.d_model, 5))
    y, st = ssm.ssm_prefill(p, x, SSM, chunk=32)
    grads = torch.autograd.grad(y.square().sum() + st["h"].sum(),
                                [p["in_proj"], p["A_log"], p["dt_bias"]])
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("S", [17, 2, 1, 64])
def test_rglru_prefill_and_decode_match_reference(rg_params, S):
    x = _x(2, S + 3, RG.d_model, S)
    y, st = rglru.rglru_prefill(_torch_tree(rg_params), torch.from_numpy(x[:, :S]), RG)
    y_ref, st_ref = jax.jit(lambda p, x: j_rglru.rglru_prefill(p, x, J_RG))(
        rg_params, jnp.asarray(x[:, :S]))
    _close(y, y_ref)
    _close(st["h"], st_ref["h"])
    _close(st["conv"], st_ref["conv"])
    for i in range(S, S + 3):
        y, st = rglru.rglru_decode(_torch_tree(rg_params), torch.from_numpy(x[:, i:i + 1]),
                                   st, RG)
        y_ref, st_ref = _J_RG_DECODE(rg_params, jnp.asarray(x[:, i:i + 1]), st_ref)
        _close(y, y_ref)
        _close(st["h"], st_ref["h"])
        _close(st["conv"], st_ref["conv"])


@pytest.mark.parametrize("n", [1, 2, 5, 8, 100])
def test_linear_scan_equals_the_sequential_recurrence(n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (3, n, 4)))
    u = torch.from_numpy(rng.standard_normal((3, n, 4)))
    h, want = torch.zeros(3, 4, dtype=torch.float64), []
    for t in range(n):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, u, dim=1), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


def test_lam_init_is_the_references():
    np.testing.assert_allclose(rglru.lam_init(RG.d_rnn).numpy(),
                               np.asarray(j_rglru.init_rglru(jax.random.PRNGKey(0), J_RG)["lam"]),
                               rtol=1e-6)
