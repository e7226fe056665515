"""The port's sharding rules against the reference's, for every leaf of
every config, full and ``.smoke()``, on duck-typed meshes of the
production shapes (16, 16), (64, 4) and (2, 16, 16).

The rules read a mesh only through its axis names and sizes, so both
packages get an object with ``axis_names`` and ``devices.shape`` (no
devices are made).  The port keeps every layer unstacked, so its spec of a
parameter (and of AdamW's ``m`` / ``v``) is the reference's with the
leading ``None`` of the stacked group axis dropped; its per-layer caches
map to the reference's prefix list and stacked groups the same way.
Parameter shapes come from the reference's ``jax.eval_shape`` and from the
port's model built on the ``meta`` device, so no weights are made.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import shapes as j_shapes
from repro.launch import sharding as j_shd
from repro.launch.steps import init_params as j_init_params
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import ARCHS, get_config, shapes
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, world
from repro_torch.models import act_sharding
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, prefix_kinds
from repro_torch.models.weights import jax_leaf_names

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "64x4": ((64, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _cfgs(arch, smoke):
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    return (j_cfg.smoke(), cfg.smoke()) if smoke else (j_cfg, cfg)


@functools.lru_cache(maxsize=None)
def _shapes(arch, smoke):
    j_cfg, cfg = _cfgs(arch, smoke)
    j_params = jax.eval_shape(functools.partial(j_init_params, cfg=j_cfg),
                              jax.random.PRNGKey(0))
    j_opt = jax.eval_shape(j_adamw_init, j_params)
    kind = EncDec if cfg.is_encdec else LM
    model = kind(cfg, device="meta", param_dtype=torch.float32)
    return j_params, j_opt, {k: p.detach() for k, p in model.named_parameters()}


class _Stacked:
    """A reference spec in place of its leaf: ``[i]`` unstacks the group
    axis, as ``jax_leaf_names`` does to arrays."""

    def __init__(self, spec, shape):
        self.spec, self.shape = tuple(spec), tuple(getattr(shape, "shape", shape))

    def __getitem__(self, i):
        spec = self.spec[1:] if self.spec else ()
        if self.spec:
            assert self.spec[0] is None, self.spec
        return _Stacked(spec, self.shape[1:])


def _by_port_name(cfg, spec_tree, shape_tree):
    leaves = jax.tree.map(_Stacked, spec_tree, shape_tree,
                          is_leaf=lambda x: isinstance(x, JP))
    return {k: v.spec for k, v in jax_leaf_names(cfg, leaves).items()}


CASES = [(a, s, m) for a in ARCHS for s in (False, True) for m in MESHES]
IDS = [f"{a}-{'smoke' if s else 'full'}-{m}" for a, s, m in CASES]


def test_the_ten_configs_are_the_references():
    assert list(ARCHS) == list(J_ARCHS)


@pytest.mark.parametrize("arch,smoke,mesh_name", CASES, ids=IDS)
def test_param_and_opt_specs_match_reference(arch, smoke, mesh_name):
    j_cfg, cfg = _cfgs(arch, smoke)
    mesh = _mesh(mesh_name)
    j_params, j_opt, names = _shapes(arch, smoke)
    want = _by_port_name(cfg, j_shd.param_pspecs(j_cfg, j_params, mesh), j_params)
    got = shd.param_pspecs(cfg, names, mesh)
    assert set(got) == set(want)
    for k, spec in got.items():
        assert isinstance(spec, shd.P)
        assert tuple(spec) == want[k], (k, spec, want[k])
    j_ospec = j_shd.opt_pspecs(j_cfg, j_opt, mesh)
    ospec = shd.opt_pspecs(cfg, {"m": names, "v": names}, mesh)
    assert tuple(ospec["count"]) == tuple(j_ospec["count"]) == ()
    for part in ("m", "v"):
        want = _by_port_name(cfg, j_ospec[part], j_opt[part])
        assert {k: tuple(v) for k, v in ospec[part].items()} == want


def _ref_cache_spec_by_layer(cfg, j_caches):
    """The reference's cache specs in the port's per-layer layout."""
    if cfg.is_encdec:
        return {part: [{k: tuple(j_caches[part][k])[1:] for k in ("k", "v")}
                       for _ in range(cfg.n_layers)] for part in ("self", "cross")}
    n_prefix, P = len(prefix_kinds(cfg)), cfg.pattern_len
    out = []
    for i in range(cfg.n_layers):
        if i < n_prefix:
            out.append({k: tuple(v) for k, v in j_caches["prefix"][i].items()})
        else:
            member = j_caches["groups"][(i - n_prefix) % P]
            out.append({k: tuple(v)[1:] for k, v in member.items()})
    return out


@pytest.mark.parametrize("arch,smoke,mesh_name", CASES, ids=IDS)
def test_batch_input_and_cache_specs_match_reference(arch, smoke, mesh_name):
    j_cfg, cfg = _cfgs(arch, smoke)
    mesh = _mesh(mesh_name)
    for B in (1, 2, 3, 16, 32, 128, 256, 512):
        assert shd.batch_axes(B, mesh) == j_shd.batch_axes(B, mesh)
    for name, shape in shapes.SHAPES.items():
        j_shape = j_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, shape) == j_shapes.skip_reason(j_cfg, j_shape)
        j_specs = j_shapes.input_specs(j_cfg, j_shape)
        specs = shapes.input_specs(cfg, shape)
        want = j_shd.input_pspecs(j_cfg, j_shape, j_specs, mesh)
        got = shd.input_pspecs(cfg, shape, specs, mesh)
        assert set(got) == set(want)
        for k in got:
            if k == "caches":
                continue
            assert tuple(specs[k].shape) == tuple(j_specs[k].shape), k
            assert str(specs[k].dtype).removeprefix("torch.") == str(j_specs[k].dtype)
            assert tuple(got[k]) == tuple(want[k]), (name, k)
        if "caches" not in got:
            continue
        ref = _ref_cache_spec_by_layer(cfg, want["caches"])
        if cfg.is_encdec:
            assert tuple(got["caches"]["cross_pos"]) == ()
            got_c = {part: [{k: tuple(v) for k, v in layer.items()}
                            for layer in got["caches"][part]] for part in ("self", "cross")}
        else:
            got_c = [{k: tuple(v) for k, v in layer.items()} for layer in got["caches"]]
        assert got_c == ref, name
        out = shd.output_pspecs(cfg, shape, {"logits": torch.empty(
            (shape.global_batch, 1, cfg.vocab_size), device="meta"),
            "caches": specs["caches"]}, mesh)
        j_out = j_shd.output_pspecs(j_cfg, j_shape, {
            "logits": jax.ShapeDtypeStruct((j_shape.global_batch, 1, j_cfg.vocab_size),
                                           np.float32),
            "caches": j_specs["caches"]}, mesh)
        assert tuple(out["logits"]) == tuple(j_out["logits"])


def test_cache_shapes_match_reference_per_layer():
    for arch in ARCHS:
        cfg, j_cfg = get_config(arch).smoke(), j_get_config(arch).smoke()
        shape = shapes.SHAPES["decode_32k"]
        got = shapes.input_specs(cfg, shape)["caches"]
        want = j_shapes.input_specs(j_cfg, j_shapes.SHAPES["decode_32k"])["caches"]
        if cfg.is_encdec:
            for part in ("self", "cross"):
                for layer in got[part]:
                    for k in ("k", "v"):
                        assert tuple(layer[k].shape) == want[part][k].shape[1:]
            continue
        n_prefix, P = len(prefix_kinds(cfg)), cfg.pattern_len
        for i, layer in enumerate(got):
            ref = want["prefix"][i] if i < n_prefix else jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                want["groups"][(i - n_prefix) % P])
            assert {k: tuple(v.shape) for k, v in layer.items()} == \
                {k: tuple(v.shape) for k, v in ref.items()}, (arch, i)
            assert {k: str(v.dtype).removeprefix("torch.") for k, v in layer.items()} == \
                {k: str(v.dtype) for k, v in ref.items()}, (arch, i)


def test_placements_and_activation_policy():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh("2x16x16")
    assert shd.placements(mesh, shd.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, shd.P()) == (Replicate(),) * 3
    cfg = get_config("deepseek-moe-16b")
    pol = shd.activation_policy(cfg, shapes.SHAPES["train_4k"], mesh)
    # the reference's policy: batch over (pod, data), vocab over model when
    # divisible (102,400 % 16 == 0), experts over model (64 % 16 == 0)
    assert set(pol) == {"residual", "logits", "moe_ecd", "moe_tokens"}
    assert tuple(pol["residual"].spec) == (("pod", "data"), None, None)
    assert pol["logits"].placements == (Shard(0), Shard(0), Shard(2))
    assert pol["moe_ecd"].placements == (Replicate(), Replicate(), Shard(0))
    assert pol["moe_tokens"].placements == (Replicate(),) * 3


def test_constrain_is_the_identity_without_a_policy_and_redistributes_with_one():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(4, 3, 8)
    act_sharding.clear_policy()
    assert not act_sharding.policy_active() and act_sharding.current_mesh() is None
    assert act_sharding.constrain(x, "residual") is x
    with world("cpu"):
        mesh = make_host_mesh(1, 1, device="cpu")
        pol = shd.activation_policy(get_config("stablelm-1.6b"),
                                    shapes.ShapeSpec("t", 8, 4, "train"), mesh)
        act_sharding.set_policy(pol)
        try:
            assert act_sharding.policy_active() and act_sharding.current_mesh() is mesh
            assert act_sharding.constrain(x, "residual") is x     # a plain tensor
            d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            out = act_sharding.constrain(d, "residual")
            assert out.placements == (Shard(0), Replicate())
            assert torch.equal(out.full_tensor(), x)
            # a rank the placements do not fit passes through (decode S=1 etc.)
            flat = distribute_tensor(torch.randn(5), mesh, [Replicate(), Replicate()])
            assert act_sharding.constrain(flat, "logits") is flat
        finally:
            act_sharding.clear_policy()
