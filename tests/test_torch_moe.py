"""The port's MoE block (``repro_torch.models.layers``: ``_capacity``,
``_moe_dispatch``, ``_moe_combine``, ``_expert_ffn``, ``moe_apply``) on
the CPU against the JAX reference's (``repro.models.layers``), at the
``scaled_down()`` sizes of qwen3-moe-30b-a3b and kimi-k2-1t-a32b (d_model
128, 4 experts, top-2, expert d_ff 256) in f32, with the reference's
routers and expert weights carried across by ``repro_torch.interop`` and
numpy-made inputs.

What must be bit-equal: the capacity; the routing (which token goes to
which expert slot, which assignments capacity drops, the (E, C, d)
buffer), ties included: ``jax.lax.top_k`` puts the lower index first
among equal values, ``torch.topk`` promises no order, so the port sorts
stably; the gates once both start from the same router probabilities;
the bf16 combine, which adds a token's k expert outputs in ascending
expert order as the reference's scatter-add does.

What is within a tolerance: the router's f32 logits and softmax differ
from XLA's in the last bits (another product order, another exp), so the
gates from the router are within 1e-4 relative (one ulp of a logit of 38
is 3.8e-6, and a gate moves with the difference of two logits); ``moe_apply``'s y within 1e-5 of
its largest magnitude and aux within 1e-6 relative.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import make_model

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
REL = 1e-5


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


def _cfgs(ref, arch, **kw):
    """(port config, reference config), scaled down, with ``kw`` changed."""
    return (dataclasses.replace(get_config(arch).scaled_down(), **kw),
            dataclasses.replace(ref.configs.get_config(arch).scaled_down(),
                                **kw))


@pytest.fixture(scope="module")
def pairs(ref):
    """arch -> (reference params as numpy, port model), same weights."""
    out = {}
    for arch in ARCHS:
        rmodel = ref.api.make_model(ref.configs.get_config(arch).scaled_down())
        params = ref.jax.tree.map(np.asarray,
                                  rmodel.init(ref.jax.random.key(0)))
        model = make_model(get_config(arch).scaled_down(), seed=None,
                           device="cpu")
        model.load_state_dict(interop.model_state(params))
        out[arch] = (params, model)
    return out


def _ref_moe(params, layer=0):
    return {k: v[layer] for k, v in params["groups"]["b0"]["moe"].items()}


def _check_routing(ref, cfg, rcfg, router, xf, C, expect_drops=None):
    """Dispatch in both packages from the same router and tokens: tok,
    dest, valid and the buffer bit-equal, gates within 1e-4, aux within
    1e-6; then from the reference's own probabilities: the gates too
    bit-equal. Returns the reference's valid mask."""
    jnp = ref.jax.numpy
    rbuf, (rtok, rdest, rvalid, rgates), raux = ref.layers._moe_dispatch(
        rcfg, jnp.asarray(router), jnp.asarray(xf), C)
    buf, (tok, dest, valid, gates), aux = L._moe_dispatch(
        cfg, torch.from_numpy(router.copy()), torch.from_numpy(xf), C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates), rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    probs = ref.jax.nn.softmax(jnp.einsum("td,de->te", xf, router).astype(
        jnp.float32), axis=-1)
    buf, (tok, dest, valid, gates), _ = L._moe_route(
        cfg, torch.from_numpy(np.array(probs)), torch.from_numpy(xf), C)
    np.testing.assert_array_equal(gates.numpy(), np.asarray(rgates))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    if expect_drops is not None:
        assert bool((~valid).any()) == expect_drops
    return np.asarray(rvalid)


# ------------------------------------------------------------ capacity

@pytest.mark.parametrize("T", [1, 4, 32, 33, 128, 129, 200, 2048, 32768])
def test_capacity_matches_reference(ref, T):
    """Both sides of T·k = 256 (k = 8 full size: T = 32 / 33; k = 2
    scaled down: T = 128 / 129), at full and scaled-down sizes; the
    full-width serve cells' 4 x 1, 4 x 512 and 1 x 32,768."""
    for arch in ARCHS:
        for mine, theirs in ((get_config(arch),
                              ref.configs.get_config(arch)),
                             _cfgs(ref, arch)):
            assert L._capacity(mine, T) == ref.layers._capacity(theirs, T)
    qwen = get_config("qwen3-moe-30b-a3b")
    assert {4: 32, 2048: 160, 32768: 2560}.get(T, L._capacity(qwen, T)) \
        == L._capacity(qwen, T)


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("T", [64, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_bit_equal_on_reference_inputs(ref, pairs, arch, T):
    """Layer 0's router of the reference's weights on T random tokens:
    T·k = 128 (dropless, C = T·k) and T·k = 600 (C = 187)."""
    params, model = pairs[arch]
    cfg, rcfg = _cfgs(ref, arch)
    router = np.asarray(_ref_moe(params)["router"])
    xf = _rng(1, T, len(arch)).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    C = L._capacity(cfg, T)
    _check_routing(ref, cfg, rcfg, router, xf, C)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_top_k_puts_the_lower_index_first_among_ties(ref, k):
    """Probabilities from four values, so rows are full of ties: values
    and indices equal ``jax.lax.top_k``'s, in its order."""
    probs = (_rng(2, k).integers(0, 4, (64, 16)) / 4.0).astype(np.float32)
    want_v, want_i = ref.jax.lax.top_k(probs, k)
    got_v, got_i = L._top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_with_duplicated_columns(ref, arch):
    """8 experts whose router columns repeat 3 distinct ones, top-4: every
    token's top-k holds tied experts, and both packages pick the same
    ones in the same order (capacity on: 64 tokens, T·k = 256 + 4)."""
    cfg, rcfg = _cfgs(ref, arch, n_experts=8, n_experts_per_tok=4)
    rng = _rng(3, len(arch))
    base = (rng.standard_normal((cfg.d_model, 3)) * 0.3).astype(np.float32)
    router = np.ascontiguousarray(base[:, [0, 1, 2, 0, 1, 2, 0, 1]])
    xf = rng.standard_normal((65, cfg.d_model)).astype(np.float32)
    C = L._capacity(cfg, 65)
    assert C < 65 * 4
    _check_routing(ref, cfg, rcfg, router, xf, C)


@pytest.mark.parametrize("arch", ARCHS)
def test_skewed_router_drops_the_same_assignments(ref, arch):
    """Tokens offset by +3 and a router whose columns 0 and 1 read their
    sum: every token routes to experts 0 and 1, C = 0.625 T, so capacity
    drops the same (latest) assignments in both packages."""
    cfg, rcfg = _cfgs(ref, arch)
    rng = _rng(4, len(arch))
    router = (rng.standard_normal((cfg.d_model, cfg.n_experts))
              * 0.02).astype(np.float32)
    router[:, 0] += 0.1
    router[:, 1] += 0.05
    T = 160
    xf = (rng.standard_normal((T, cfg.d_model)) + 3.0).astype(np.float32)
    C = L._capacity(cfg, T)
    valid = _check_routing(ref, cfg, rcfg, router, xf, C,
                           expect_drops=True)
    assert int((~valid).sum()) == 2 * (T - C)


def test_combine_adds_in_ascending_expert_order_in_bf16(ref):
    """The combine in bf16 against the reference's scatter-add, bit for
    bit (16 experts, top-8, 100 tokens; capacity drops some): each token's
    contributions added one after another onto +0.0, lowest expert
    first. Adding them from the highest expert down, or accumulating in
    f32, gives other bits on these inputs. (On the CPU ``index_add_``
    also adds in index order; on the card it adds by atomics, in no fixed
    order, so the port does not use it.)"""
    jnp = ref.jax.numpy
    cfg, rcfg = _cfgs(ref, ARCHS[0], n_experts=16, n_experts_per_tok=8)
    rng = _rng(5)
    T, d = 100, cfg.d_model
    # offset tokens: the router's column sums pick favourite experts
    xf = (rng.standard_normal((T, d)) + 1.0).astype(np.float32)
    router = (rng.standard_normal((d, 16)) * 0.3).astype(np.float32)
    C = L._capacity(cfg, T)
    _, rcomb, _ = ref.layers._moe_dispatch(rcfg, jnp.asarray(router),
                                           jnp.asarray(xf), C)
    assert not bool(np.asarray(rcomb[2]).all())
    out = rng.standard_normal((16, C, d)).astype(ml_dtypes.bfloat16)
    want = np.asarray(ref.layers._moe_combine(rcomb, jnp.asarray(out), T,
                                              jnp.bfloat16)).view(np.int16)
    comb = tuple(torch.from_numpy(np.array(a)) for a in rcomb)
    out_t = torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    got = L._moe_combine(comb, out_t, T, torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)

    tok, dest, valid, gates = comb
    flat, w = out_t.reshape(-1, d), (valid * gates).to(torch.bfloat16)
    slots = torch.argsort(tok, stable=True).view(T, -1)

    def summed(js, acc):
        y = torch.zeros(T, d, dtype=acc)
        for j in js:
            y = y + (flat[dest[slots[:, j]]] * w[slots[:, j], None]).to(acc)
        return y.to(torch.bfloat16).view(torch.int16).numpy()

    assert not np.array_equal(summed(range(7, -1, -1), torch.bfloat16), want)
    assert not np.array_equal(summed(range(8), torch.float32), want)


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("shape", [(2, 16), (2, 100)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(ref, pairs, arch, shape):
    """Layer 0's MoE block on (B, S) tokens: T·k = 64 (dropless) and
    T·k = 400 (capacity 125): y within 1e-5 of its largest magnitude, aux
    within 1e-6."""
    params, model = pairs[arch]
    cfg, rcfg = _cfgs(ref, arch)
    x = _rng(6, *shape).standard_normal(shape + (cfg.d_model,)).astype(
        np.float32)
    want_y, want_aux = ref.layers.moe_apply(rcfg, _ref_moe(params), x)
    with torch.no_grad():
        y, aux = L.moe_apply(cfg, model.layers[0].moe, torch.from_numpy(x))
    _close(y, want_y)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_expert_ffn_matches_reference(ref, pairs):
    params, model = pairs[ARCHS[1]]
    buf = _rng(7).standard_normal((4, 9, 128)).astype(np.float32)
    want = ref.layers._expert_ffn(_ref_moe(params), buf)
    with torch.no_grad():
        got = L._expert_ffn(model.layers[0].moe, torch.from_numpy(buf))
    _close(got, want)


def test_ep_without_a_mesh_runs_the_auto_route(pairs):
    """``moe_impl="ep"`` with no mesh falls through to the auto route, as
    the reference's does: the same bits."""
    _, model = pairs[ARCHS[0]]
    x = torch.from_numpy(_rng(8).standard_normal((2, 70, 128)).astype(
        np.float32))
    with torch.no_grad():
        auto = L.moe_apply(model.cfg, model.layers[0].moe, x)
        ep = L.moe_apply(model.cfg, model.layers[0].moe, x,
                         flags={"moe_impl": "ep"})
    assert torch.equal(auto[0], ep[0]) and torch.equal(auto[1], ep[1])


def _mesh(data, model=1):
    from repro_torch.core.dist import Mesh
    return Mesh(("data", "model"), {"data": data, "model": model},
                {"data": 0, "model": 0})


@pytest.mark.parametrize("flags, error, match", [
    ({"_in_manual": True}, ValueError, "'data' axis of flags"),
    ({"mesh": _mesh(2)}, ValueError, "build the model with launch.sharding"),
    ({"mesh": _mesh(2, 2)}, NotImplementedError,
     "ROADMAP Queue 1 item 10 step 6, part B \\(3\\)")])
def test_ep_under_a_mesh_raises(pairs, flags, error, match):
    """The expert-parallel route's refusals (it runs in
    ``test_torch_ep.py``): under ``_in_manual`` without a mesh; under a
    mesh whose data axis splits the experts while the block holds all of
    them (the rules would give this rank a half); over a "model" axis of
    more than one rank."""
    _, model = pairs[ARCHS[0]]
    x = torch.zeros(1, 4, 128)
    with pytest.raises(error, match=match):
        L.moe_apply(model.cfg, model.layers[0].moe, x,
                    flags={"moe_impl": "ep", **flags})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_give_the_same_bits(pairs, dtype):
    """The block is deterministic: routing by stable sorts, the combine
    without atomics (bf16 weights too)."""
    _, model = pairs[ARCHS[0]]
    p = {k: v.detach().to(dtype) for k, v in
         model.layers[1].moe.named_parameters()}
    x = torch.from_numpy(_rng(9).standard_normal((4, 64, 128)).astype(
        np.float32)).to(dtype)
    a = L.moe_apply(model.cfg, p, x)
    b = L.moe_apply(model.cfg, p, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == dtype and a[1].dtype == torch.float32


def test_init_moe_shapes_and_scales():
    """Router (d, E) at 0.02; experts (E, d, f), (E, d, f), (E, f, d) at
    1/sqrt(E), the reference's first-axis rule (0.088 at E = 128)."""
    cfg = dataclasses.replace(get_config(ARCHS[0]).scaled_down(),
                              n_experts=64, n_layers=1)
    model = make_model(cfg, seed=1, device="cpu")
    moe = model.layers[0].moe
    d, f, E = cfg.d_model, cfg.d_ff, 64
    shapes = {n: tuple(p.shape) for n, p in moe.named_parameters()}
    assert shapes == {"router": (d, E), "w_gate": (E, d, f),
                      "w_up": (E, d, f), "w_down": (E, f, d)}
    np.testing.assert_allclose(float(moe.router.detach().std()), 0.02,
                               rtol=0.05)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(float(getattr(moe, name).detach().std()),
                                   1 / np.sqrt(E), rtol=0.02)
