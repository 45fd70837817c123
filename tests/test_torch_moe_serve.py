"""The port's MoE models (``repro_torch.models`` with the MoE block in every
layer: qwen3-moe-30b-a3b and kimi-k2-1t-a32b) on the CPU against the JAX
reference at their ``scaled_down()`` sizes in f32 (2 layers, d_model 128,
4 heads, 4 experts top-2, expert d_ff 256, vocab 512), with the
reference's weights carried across by ``repro_torch.interop.model_state``
and the same numpy-made tokens: the loss with its aux term and its
gradients, prefill and decode on both attention routes, the parameter
counts and the layer structure.

Tolerances: ce, aux and every gradient leaf within 1e-5 (of the largest
magnitude for tensors, as ``test_torch_dense.py``); logits within the
serve tests' 1e-4. Prompts of 2 x 80 tokens give T·k = 320 > 256, so
the prefill runs the capacity path (C = 200); decode (T·k = 4) the
dropless one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (active_param_count, decode_step, loss_fn,
                                make_model, param_count, prefill)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
REL = 1e-5
SERVE_REL = 1e-4


def _close(port, want, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    want = np.asarray(want)
    assert port.shape == want.shape, (port.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(port, want, rtol=rel, atol=rel * scale)
    if scale:
        print(f"gap {np.max(np.abs(port - want)) / scale:.3g} of the "
              f"largest magnitude")


def _rng(*key):
    return np.random.default_rng(list(key))


@pytest.fixture(scope="module")
def pairs(ref):
    """arch -> (reference model, its params as numpy, port model)."""
    out = {}
    for arch in ARCHS:
        rmodel = ref.api.make_model(ref.configs.get_config(arch).scaled_down())
        params = ref.jax.tree.map(np.asarray,
                                  rmodel.init(ref.jax.random.key(0)))
        model = make_model(get_config(arch).scaled_down(), seed=None,
                           device="cpu")
        model.load_state_dict(interop.model_state(params))
        out[arch] = (rmodel, params, model)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(ref, pairs, arch):
    """``loss_fn`` on 2 x 80 tokens: ce and aux within 1e-5, the loss =
    ce + 0.01 aux, and each gradient leaf (the routers' and experts'
    included) within 1e-5 of its largest magnitude."""
    rmodel, params, model = pairs[arch]
    jax = ref.jax
    tokens = _rng(1, len(arch)).integers(0, model.cfg.vocab_size, (2, 80))
    batch = {"tokens": jax.numpy.asarray(tokens, jax.numpy.int32)}
    (want, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref.api.loss_fn(rmodel, p, batch), has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    loss, mine = loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(mine["ce"].detach()),
                               float(metrics["ce"]), rtol=REL)
    np.testing.assert_allclose(float(mine["aux"].detach()),
                               float(metrics["aux"]), rtol=REL)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=REL)
    assert torch.equal(loss, mine["ce"] + 0.01 * mine["aux"])
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    leaves = interop.reference_leaves(model)
    assert [lf.key for lf in leaves] == [
        "/".join(str(q.key) for q in path) for path, _ in flat]
    for leaf, (_, g) in zip(leaves, flat):
        _close(leaf.value(lambda p: p.grad), g)


@pytest.mark.parametrize("impl", ["einsum", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, pairs, arch, impl):
    """Prefill of 2 x 80 tokens into an 86-slot cache, then 5 decode
    steps fed the same tokens, on each attention route, against the
    reference on the same route: logits within 1e-4."""
    rmodel, params, model = pairs[arch]
    jnp = ref.jax.numpy
    jparams = ref.jax.tree.map(jnp.asarray, params)
    fl = {"attn_impl": impl}
    rng = _rng(2, len(arch), len(impl))
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 80))
    feed = rng.integers(0, model.cfg.vocab_size, (2, 5))
    want, r_caches, _ = ref.api.prefill(
        rmodel, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, 86, fl)
    got, caches, memory = prefill(
        model, {"tokens": torch.from_numpy(tokens)}, 86, fl)
    assert memory is None
    _close(got, want, SERVE_REL)
    for i in range(5):
        pos = np.full((2,), 80 + i, np.int32)
        want, r_caches = ref.api.decode_step(
            rmodel, jparams, jnp.asarray(feed[:, i:i + 1], jnp.int32),
            jnp.asarray(pos), r_caches, flags=fl)
        got, caches = decode_step(
            model, torch.from_numpy(feed[:, i:i + 1]),
            torch.from_numpy(pos).long(), caches, flags=fl)
        _close(got, want, SERVE_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_match_reference(ref, pairs, arch):
    """``param_count`` and ``active_param_count`` equal the reference's at
    the scaled-down sizes (where H = E, so the reference counts ``wo`` as
    expert weights too) and at full size (counted on the meta device
    against the reference's abstract params): qwen3-moe 30,532,122,624
    and 3,353,032,704 active; kimi-k2 1,041,166,988,288."""
    rmodel, params, model = pairs[arch]
    cfg = model.cfg
    assert param_count(model) == ref.api.param_count(params)
    assert active_param_count(cfg, model) == \
        ref.api.active_param_count(rmodel.cfg, params)
    full = get_config(arch)
    big = make_model(full, seed=None, device="meta")
    rfull = ref.api.make_model(ref.configs.get_config(arch))
    abstract = rfull.abstract_params()
    assert param_count(big) == ref.api.param_count(abstract)
    assert active_param_count(full, big) == \
        ref.api.active_param_count(rfull.cfg, abstract)
    want = {"qwen3-moe-30b-a3b": (30_532_122_624, 3_353_032_704),
            "kimi-k2-1t-a32b": (1_041_166_988_288, None)}[arch]
    assert param_count(big) == want[0]
    if want[1] is not None:
        assert active_param_count(full, big) == want[1]
    assert all(p.dtype == torch.bfloat16 for p in big.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routes_to_multiple_experts(pairs, arch):
    """The reference's own bound on the switch aux loss (about 1 a layer
    when balanced, large when routing collapses): 0.5 < aux / n_layers
    < 4, on the reference's weights and on the port's own draw."""
    _, _, model = pairs[arch]
    tokens = torch.from_numpy(_rng(3).integers(0, model.cfg.vocab_size,
                                               (2, 32)))
    own = make_model(model.cfg, seed=7, device="cpu")
    for m in (model, own):
        with torch.no_grad():
            _, metrics = loss_fn(m, {"tokens": tokens})
        assert 0.5 < float(metrics["aux"]) / m.cfg.n_layers < 4.0


def test_moe_layers_hold_the_moe_block_not_the_mlp(pairs):
    """Each MoE layer holds ln1, attn, ln2 and the ``moe`` scope, never an
    MLP beside it (the reference's ``_init_layer``), and its parameters
    are named ``layers.<i>.moe.<leaf>``."""
    _, params, model = pairs[ARCHS[0]]
    for i, layer in enumerate(model.layers):
        names = {n.split(".")[0] for n, _ in layer.named_parameters()}
        assert names == {"ln1", "attn", "ln2", "moe"}
    state = model.state_dict()
    assert {k for k in state if ".moe." in k} == {
        f"layers.{i}.moe.{leaf}" for i in range(model.cfg.n_layers)
        for leaf in ("router", "w_gate", "w_up", "w_down")}
    np.testing.assert_array_equal(
        state["layers.1.moe.w_down"].numpy(),
        params["groups"]["b0"]["moe"]["w_down"][1])


def test_serve_cli_on_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--arch", ARCHS[0], "--tokens", "3",
                    "--batch", "2", "--prompt-len", "70"])
    out = capsys.readouterr().out
    assert f"[{ARCHS[0]}] prefill(2x70)" in out
    assert "decoded 3 tokens x 2 requests" in out


def test_moe_leaves_map_across_groups_and_tail(ref):
    """``interop`` maps ``groups/b<i>/moe/<leaf>`` and ``tail/<j>/moe/<leaf>``
    to ``layers.<i>.moe.<leaf>`` and back: a 3-layer MoE model of pattern
    (local, global) has one group of two and a tail layer; its leaves are
    the reference's tree, key, shape and value, and its loss (ce and aux)
    the reference's."""
    kw = dict(n_layers=3, layer_pattern=("local", "global"), window_size=8)
    rmodel = ref.api.make_model(dataclasses.replace(
        ref.configs.get_config(ARCHS[0]).scaled_down(), **kw))
    params = ref.jax.tree.map(np.asarray, rmodel.init(ref.jax.random.key(2)))
    cfg = dataclasses.replace(get_config(ARCHS[0]).scaled_down(), **kw)
    model = make_model(cfg, seed=None, device="cpu")
    model.load_state_dict(interop.model_state(params))
    flat = ref.jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = interop.reference_leaves(model)
    assert [lf.key for lf in leaves] == [
        "/".join(str(q.key) for q in path) for path, _ in flat]
    assert "tail/0/moe/w_gate" in [lf.key for lf in leaves]
    for leaf, (_, a) in zip(leaves, flat):
        np.testing.assert_array_equal(leaf.value().detach().numpy(), a)
    tokens = _rng(4).integers(0, cfg.vocab_size, (2, 20))
    jnp = ref.jax.numpy
    _, want = ref.api.loss_fn(rmodel, ref.jax.tree.map(jnp.asarray, params),
                              {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        _, mine = loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(mine[key]), float(want[key]),
                                   rtol=REL)
