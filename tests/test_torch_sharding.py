"""The port's logical axes and sharding rules (``models.common``'s
recorded axes, ``Transformer.axes()``, ``launch/sharding.py``) against
the reference's (``repro.models.transformer.Transformer.axes``,
``repro.launch.sharding``), on the CPU.

What must be equal: every leaf's logical axes, leaf for leaf in
``jax.tree.leaves`` order, for the 10 archs at full size (the port on the
meta device, the reference abstractly) and at ``scaled_down()``; every
leaf's resolved spec on four mesh shapes that need no devices ((data,
model) = (2, 1), (4, 2), (16, 16) and (pod, data, model) = (2, 16, 16));
the caches' and batches' axes, and ``decode_rules``, at batch 8 and 1.
And ``local_block`` over the ranks of a spec's axes covers each entry of
a leaf exactly once.
"""
import itertools

import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module fixture)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.dist import Mesh
from repro_torch.launch import sharding
from repro_torch.models import batch_spec, make_model

MESHES = {"2x1": (("data", "model"), (2, 1)),
          "4x2": (("data", "model"), (4, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _mesh(name, coords=None):
    axes, shape = MESHES[name]
    return Mesh(axes, dict(zip(axes, shape)),
                coords or {a: 0 for a in axes})


def _ref_leaves(ref, tree):
    return ref.jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple)
                               and all(isinstance(e, str) for e in x))


@pytest.fixture(scope="module")
def models(ref):
    """(size, arch) -> (port model on the meta device, reference model)."""
    out = {}
    for arch in ARCH_IDS:
        for size in ("full", "small"):
            cfg, rcfg = get_config(arch), ref.configs.get_config(arch)
            if size == "small":
                cfg, rcfg = cfg.scaled_down(), rcfg.scaled_down()
            out[size, arch] = (make_model(cfg, seed=None, device="meta"),
                               ref.transformer.Transformer(rcfg))
    return out


@pytest.mark.parametrize("size", ["full", "small"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_equal_the_reference(ref, models, size, arch):
    port, rmodel = models[size, arch]
    want = _ref_leaves(ref, rmodel.axes)
    assert port.axes() == [tuple(a) for a in want]
    shapes = [tuple(s.shape) for s in ref.jax.tree.leaves(
        rmodel.abstract_params())]
    assert port.full_shapes() == shapes


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(ref, models, mesh_name, arch):
    """``params_specs`` at full size against the reference's
    ``ShardingRules.tree_specs`` on the same mesh shape."""
    from jax.sharding import PartitionSpec as P
    from repro.launch.sharding import ShardingRules
    port, rmodel = models["full", arch]
    mesh = _mesh(mesh_name)
    want = ref.jax.tree.leaves(
        ShardingRules.default().tree_specs(mesh, rmodel.abstract_params(),
                                           rmodel.axes),
        is_leaf=lambda x: isinstance(x, P))
    got = sharding.params_specs(mesh, port)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert all(isinstance(s, sharding.Spec) for s in got)


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_axes_and_decode_rules(ref, models, arch, batch):
    """The caches' axes layer by layer (a grouped layer's are its stacked
    leaf's without "layers"), the batch's axes, and ``decode_rules``'
    rules and a cache leaf's spec on the (16, 16) mesh."""
    from repro.launch.sharding import batch_axes, cache_axes, decode_rules
    port, rmodel = models["small", arch]
    cfg = port.cfg
    got = sharding.cache_axes(port.init_cache(batch, 16))
    want = cache_axes(rmodel.init_cache(batch, 16))
    size = len(cfg.layer_pattern)
    n_grouped = cfg.n_layers // size * size
    for i, layer in enumerate(got):
        if i < n_grouped:
            w = ref.jax.tree.map(lambda a: a[1:], want["groups"][f"b{i % size}"],
                                 is_leaf=lambda x: isinstance(x, tuple))
        else:
            w = want["tail"][str(i - n_grouped)]
        assert layer == w, i
    spec = batch_spec(cfg, batch, 32)
    rspec = ref.api.batch_spec(ref.configs.get_config(arch).scaled_down(),
                               batch, 32)
    assert sharding.batch_axes(spec) == batch_axes(rspec)
    mesh = _mesh("16x16")
    rules, rrules = (sharding.decode_rules(batch, mesh),
                     decode_rules(batch, mesh))
    assert rules.rules == rrules.rules
    shape = (batch, 524288, 8, 128)
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    assert tuple(rules.spec_for(mesh, shape, axes)) == tuple(
        rrules.spec_for(mesh, shape, axes))


@pytest.mark.parametrize("mesh_name", ["2x1", "4x2", "2x16x16"])
def test_local_blocks_cover_each_leaf_once(mesh_name):
    """For every leaf of scaled-down qwen3-moe and recurrentgemma, the
    blocks of the ranks along the spec's axes cover each entry once, and
    each has ``local_shape``."""
    axes_names, shape = MESHES[mesh_name]
    for arch in ("qwen3-moe-30b-a3b", "recurrentgemma-2b"):
        model = make_model(get_config(arch).scaled_down(), seed=None,
                           device="meta")
        mesh0 = _mesh(mesh_name)
        for full, spec in zip(model.full_shapes(),
                              sharding.params_specs(mesh0, model)):
            used = sharding.spec_axes(spec)
            seen = np.zeros(full, np.int64)
            for coord in itertools.product(*(range(mesh0.shape[a])
                                             for a in used)):
                mesh = _mesh(mesh_name, {**{a: 0 for a in axes_names},
                                         **dict(zip(used, coord))})
                block = sharding.local_block(seen, spec, mesh)
                assert block.shape == sharding.local_shape(full, spec, mesh)
                block += 1
            assert (seen == 1).all(), (arch, full, spec)


def test_spec_rules_and_refusals():
    """Divisibility falls through to replication, a mesh axis cuts one
    dimension, tuples of axes stay tuples, trailing Nones go."""
    rules = sharding.ShardingRules.default()
    mesh = _mesh("2x16x16")
    assert rules.spec_for(mesh, (32, 4096), ("heads", "embed")) == \
        sharding.Spec("model")
    assert rules.spec_for(mesh, (10, 256), ("heads", "head_dim")) == \
        sharding.Spec()
    assert rules.spec_for(mesh, (2560, 2560), ("lru", "lru")) == \
        sharding.Spec("model")
    assert rules.spec_for(mesh, (64, 7), ("batch", "seq")) == \
        sharding.Spec(("pod", "data"))
    assert sharding.restrict(sharding.Spec(("pod", "data"), "model"),
                             ("data",)) == sharding.Spec(("data",))
    with pytest.raises(ValueError):
        rules.spec_for(mesh, (3, 4), ("embed",))
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_shape((3, 4), sharding.Spec("data"), mesh)
    t = torch.arange(12).reshape(4, 3)
    m = Mesh(("data", "model"), {"data": 2, "model": 1},
             {"data": 1, "model": 0})
    assert torch.equal(sharding.local_block(t, sharding.Spec("data"), m),
                       t[2:])
