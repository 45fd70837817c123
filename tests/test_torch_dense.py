"""The port's dense layers (``repro_torch.models``: RoPE, attention in
train mode, the SwiGLU MLP, ``loss_fn`` and its gradients) on the CPU
against the JAX reference (``repro.models``) in f32, with the reference's
weights carried across by ``repro_torch.interop.model_state`` and the same
numpy-made inputs.

Configs: an explicit one with 4 heads and 2 KV heads (G = 2: the
``scaled_down()`` llama configs have G = 1), G = 4, qk_norm, and the local
(sliding-window) kind; and the ``scaled_down()`` tinyllama, llama3.2,
qwen3 (qk_norm) and gemma3 (five local layers, one global).

Tolerance: rtol 1e-5 plus 1e-5 of the largest magnitude (``_close``);
XLA fuses and contracts products and sums into FMAs and its exp, pow and
log differ from torch's in the last bit, so no tensor is bit-equal.
``pytest -s`` prints each gap as a share of the largest magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import (loss_fn, make_batch, make_model,
                                param_count, prefill)
from repro_torch.models.common import ModelConfig, rope, swiglu

pytestmark = pytest.mark.usefixtures("one_thread")

REL = 1e-5
SMALL = dict(name="dense-small", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=128, head_dim=16)
VARIANTS = {
    "gqa2": {},
    "gqa4-qknorm": dict(n_kv_heads=1, qk_norm=True),
    "mha-local": dict(n_kv_heads=4, layer_pattern=("local",),
                      window_size=5),
    "local-global-tail": dict(n_layers=3, layer_pattern=("local", "global"),
                              window_size=4),
}
ARCHS = ("tinyllama-1.1b", "llama3.2-1b", "qwen3-8b", "gemma3-4b")


def _close(port, want, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    want = np.asarray(want)
    assert port.shape == want.shape, (port.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(port, want, rtol=rel, atol=rel * scale)
    if scale:
        print(f"gap {np.max(np.abs(port - want)) / scale:.3g} of the "
              f"largest magnitude")


def _configs(ref, variant=None, arch=None):
    """(port config, reference config), both f32."""
    if arch is not None:
        return (get_config(arch).scaled_down(),
                ref.configs.get_config(arch).scaled_down())
    kw = {**SMALL, **VARIANTS[variant]}
    return (ModelConfig(**kw, dtype=torch.float32),
            ref.common.ModelConfig(**kw, dtype=ref.jax.numpy.float32))


def _pair(ref, variant=None, arch=None, seed=0):
    """(reference model, its params as numpy, port model), same weights."""
    cfg, rcfg = _configs(ref, variant, arch)
    rmodel = ref.api.make_model(rcfg)
    params = ref.jax.tree.map(np.asarray,
                              rmodel.init(ref.jax.random.key(seed)))
    model = make_model(cfg, seed=None, device="cpu")
    model.load_state_dict(interop.model_state(params))
    return rmodel, params, model


def _tokens(cfg, batch=3, seq=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


# ----------------------------------------------------------- primitives

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(ref, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = ref.common.rope(x, pos, theta)
    _close(rope(torch.from_numpy(x), torch.from_numpy(pos), theta), want)


def test_swiglu_matches_reference(ref):
    rng = np.random.default_rng(2)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32)
                 for s in ((3, 5, 16), (16, 24), (16, 24)))
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    want = ref.common.swiglu(x, wg, wu, wd)
    got = swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_causal_mask_bit_equal(ref, window):
    pq = np.stack([np.arange(7), np.arange(7) + 3]).astype(np.int32)
    pk = pq.copy()
    pk[1, :2] = -1                          # unwritten keys are masked
    want = np.asarray(ref.layers._causal_mask(pq, pk, window))
    got = L._causal_mask(torch.from_numpy(pq), torch.from_numpy(pk), window)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["gqa2", "gqa4-qknorm", "mha-local"])
def test_attention_matches_reference(ref, variant):
    """Train-mode attention of layer 0 (query head h reads KV head
    h // G; qk_norm; the local kind's window)."""
    rmodel, params, model = _pair(ref, variant)
    cfg = model.cfg
    x = np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    kind = cfg.kind(0)
    p0 = ref.jax.tree.map(lambda a: a[0], params["groups"]["b0"]["attn"])
    want, _ = ref.layers.attention_apply(rmodel.cfg, p0, x, pos, kind=kind)
    got, cache = L.attention_apply(cfg, model.layers[0].attn,
                                   torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()), kind=kind)
    assert cache is None
    _close(got, want)


def test_attention_gqa_reads_its_kv_head(ref):
    """With G = 2, moving KV head 1 moves query heads 2 and 3 only."""
    _, _, model = _pair(ref, "gqa2")
    cfg, attn = model.cfg, model.layers[0].attn
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32))
    pos = torch.arange(6)[None]
    q = torch.einsum("bsd,dhk->bshk", x, attn.wq)
    k = torch.einsum("bsd,dhk->bshk", x, attn.wk)
    v = torch.einsum("bsd,dhk->bshk", x, attn.wv)
    mask = L._causal_mask(pos, pos, None)
    base = L._attend_einsum(q, k, v, mask)
    v2 = v.clone()
    v2[:, :, 1] += 1.0
    moved = (L._attend_einsum(q, k, v2, mask) - base).abs().amax(dim=(0, 1, 3))
    assert moved[:2].max() == 0 and moved[2:].min() > 0


def test_mlp_matches_reference(ref):
    rmodel, params, model = _pair(ref, "gqa2")
    x = np.random.default_rng(5).standard_normal(
        (2, 7, model.cfg.d_model)).astype(np.float32)
    p1 = ref.jax.tree.map(lambda a: a[1], params["groups"]["b0"]["mlp"])
    want = ref.layers.mlp_apply(rmodel.cfg, p1, x)
    _close(L.mlp_apply(model.cfg, model.layers[1].mlp, torch.from_numpy(x)),
           want)


# ----------------------------------------------------- model and loss

def _check_loss_and_grads(ref, rmodel, params, model, toks):
    jax = ref.jax
    want, grads = jax.jit(jax.value_and_grad(lambda p: ref.api.loss_fn(
        rmodel, p, {"tokens": toks})[0]))(params)
    loss, metrics = loss_fn(model, {"tokens": torch.from_numpy(toks).long()})
    _close(loss, want)
    # no MoE layer: aux is 0 and the loss is the cross-entropy's bits
    assert torch.equal(metrics["ce"], loss) and float(metrics["aux"]) == 0.0
    loss.backward()
    flat = ref.jax.tree_util.tree_flatten_with_path(grads)[0]
    leaves = interop.reference_leaves(model)
    assert len(leaves) == len(flat)
    for leaf, (path, g) in zip(leaves, flat):
        assert leaf.key == "/".join(str(q.key) for q in path)
        _close(leaf.value(lambda p: p.grad), g)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_reference(ref, variant):
    rmodel, params, model = _pair(ref, variant)
    _check_loss_and_grads(ref, rmodel, params, model,
                          _tokens(model.cfg, seed=6))


@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_down_loss_and_grads_match_reference(ref, arch):
    rmodel, params, model = _pair(ref, arch=arch)
    _check_loss_and_grads(ref, rmodel, params, model,
                          _tokens(model.cfg, batch=2, seq=16, seed=7))


@pytest.mark.parametrize("variant", ["gqa2", "local-global-tail"])
def test_reference_leaves_are_the_reference_tree(ref, variant):
    """``interop.reference_leaves`` gives the reference's leaves in
    ``jax.tree.leaves`` order, stacked over groups (and the tail's own),
    and ``model_state`` is its inverse."""
    _, params, model = _pair(ref, variant)
    flat = ref.jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = interop.reference_leaves(model)
    assert [lf.key for lf in leaves] == [
        "/".join(str(q.key) for q in path) for path, _ in flat]
    for leaf, (_, a) in zip(leaves, flat):
        assert leaf.shape == a.shape
        assert leaf.stacked == leaf.key.startswith("groups/")
        np.testing.assert_array_equal(leaf.value().detach().numpy(), a)
        parts = leaf.parts(leaf.value())
        assert all(torch.equal(p, q) for p, q in zip(parts, leaf.params))


def test_dense_layers_have_attention_and_mlp_only(ref):
    """A global/local layer holds ln1, attn, ln2 and the MLP as the
    reference's ``_init_layer``; none carries a Mamba block, and every
    parameter trains."""
    _, _, model = _pair(ref, "local-global-tail")
    for layer in model.layers:
        names = {n.split(".")[0] for n, _ in layer.named_parameters()}
        assert names == {"ln1", "attn", "ln2", "mlp"}
    assert all(p.requires_grad for p in model.parameters())


# full size on the meta device: parameters, reference leaves, largest leaf
FULL_SIZE = {
    "tinyllama-1.1b": (1_100_048_384, 12, 253_755_392),
    "llama3.2-1b": (1_498_482_688, 12, 268_435_456),
    "qwen3-8b": (8_190_735_360, 14, 1_811_939_328),
    "gemma3-4b": (4_551_013_888, 113, 671_088_640),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_parameter_count(ref, arch):
    """The dense archs' bf16 parameters at full size, counted on the meta
    device, as the reference's abstract params count them; their
    reference leaves (gemma3-4b: 5 groups of 6 layers and 4 tail layers)
    and the largest leaf."""
    n_params, n_leaves, largest = FULL_SIZE[arch]
    model = make_model(get_config(arch), seed=None, device="meta")
    theirs = ref.jax.tree.leaves(ref.api.make_model(
        ref.configs.get_config(arch)).abstract_params())
    assert param_count(model) == n_params
    assert param_count(model) == sum(int(np.prod(x.shape)) for x in theirs)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    leaves = interop.reference_leaves(model)
    assert len(leaves) == len(theirs) == n_leaves
    assert [lf.shape for lf in leaves] == [tuple(x.shape) for x in theirs]
    assert max(int(np.prod(lf.shape)) for lf in leaves) == largest


def test_chunked_route_matches_einsum_and_front_end_blocks(ref):
    """Dense models serve on both attention routes: the chunked (online
    softmax) prefill and decode of scaled-down tinyllama equal the einsum
    route's within the tolerance (a prompt of 40, then one decode step
    over the 48-slot cache). The front ends' blocks, which raised here
    until they were ported, run on the chunked route as the reference's
    does: cross-attention over a 2 x 40 memory and the bidirectional
    encoder kind, on tinyllama's weights."""
    model = make_model(get_config("tinyllama-1.1b").scaled_down(),
                       device="cpu")
    tokens = torch.from_numpy(_tokens(model.cfg, batch=2, seq=40, seed=8))
    chunked = {"attn_impl": "chunked"}
    want, caches_e, _ = prefill(model, {"tokens": tokens}, cache_len=48)
    got, caches_c, _ = prefill(model, {"tokens": tokens}, cache_len=48,
                               flags=chunked)
    _close(got, want)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 1, model.cfg.d_model)).astype(np.float32))
    pos = torch.full((2, 1), 40)
    attn = model.layers[0].attn
    with torch.no_grad():
        want, _ = L.attention_apply(model.cfg, attn, x, pos, mode="decode",
                                    cache=caches_e[0]["attn"])
        got, _ = L.attention_apply(model.cfg, attn, x, pos, mode="decode",
                                   cache=caches_c[0]["attn"], flags=chunked)
    _close(got, want)
    jnp = ref.jax.numpy
    rcfg = ref.configs.get_config("tinyllama-1.1b").scaled_down()
    p_r = {k: jnp.asarray(v.detach().numpy())
           for k, v in attn.named_parameters()}
    mem = np.random.default_rng(10).standard_normal(
        (2, 40, model.cfg.d_model)).astype(np.float32)
    pos40 = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    for kw, rkw in ((dict(cross_kv=torch.from_numpy(mem)),
                     dict(cross_kv=jnp.asarray(mem))),
                    (dict(kind="encoder"), dict(kind="encoder"))):
        q = mem if "kind" in kw else np.asarray(x)
        qpos = pos40 if "kind" in kw else np.asarray(pos, np.int32)
        with torch.no_grad():
            got, _ = L.attention_apply(model.cfg, attn, torch.from_numpy(q),
                                       torch.from_numpy(qpos.copy()),
                                       flags=chunked, **kw)
        want, _ = ref.layers.attention_apply(
            rcfg, p_r, jnp.asarray(q), jnp.asarray(qpos), flags=chunked,
            **rkw)
        _close(got, want)


def test_moe_and_front_ends_build_with_finite_loss():
    """MoE models build (qwen3-moe's scaled-down loss is finite, its aux
    term positive); the audio and VLM front ends, which raised here until
    they were ported, build and give a finite loss on ``make_batch``'s
    frames or patches; a text model given a VLM config reads a patch
    prefix."""
    moe = make_model(get_config("qwen3-moe-30b-a3b").scaled_down(),
                     device="cpu")
    loss, metrics = loss_fn(moe, {"tokens": torch.zeros((1, 4),
                                                        dtype=torch.long)})
    assert bool(torch.isfinite(loss)) and float(metrics["aux"].detach()) > 0
    for arch in ("whisper-tiny", "internvl2-2b"):
        cfg = get_config(arch).scaled_down()
        model = make_model(cfg, device="cpu")
        batch = make_batch(cfg, 2, 12, torch.Generator().manual_seed(1))
        assert set(batch) == {"tokens", "frames" if arch == "whisper-tiny"
                              else "patches"}
        loss, _ = loss_fn(model, batch)
        assert bool(torch.isfinite(loss)) and float(loss.detach()) > 0
    model = make_model(get_config("tinyllama-1.1b").scaled_down(),
                       device="cpu")
    model.cfg = dataclasses.replace(model.cfg, arch_type="vlm",
                                    vision_prefix=3)
    with pytest.raises(KeyError, match="patches"):
        loss_fn(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    loss, _ = loss_fn(model, {"tokens": torch.zeros((1, 4),
                                                    dtype=torch.long),
                              "patches": torch.zeros(1, 3,
                                                     model.cfg.d_model)})
    assert bool(torch.isfinite(loss))
