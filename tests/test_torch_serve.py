"""The port's serve path for attention and RG-LRU models
(``repro_torch.models``: the KV ring buffer, attention's prefill and decode
modes, the RG-LRU block on its two routes, ``api.prefill`` /
``decode_step``) on the CPU against the JAX reference (``repro.models``),
at the ``scaled_down()`` sizes of recurrentgemma-2b (pattern rglru, rglru,
local; d_model 128, lru_width 128, 4 heads / 1 KV head of 32, window 64,
vocab 512) and tinyllama-1.1b (two global layers) in f32, with the
reference's weights carried across by ``repro_torch.interop.model_state``
and the same numpy-made inputs.

Tolerance: every tensor within rtol 1e-4 plus 1e-4 of its largest
magnitude (``_close``), as ``test_torch_mamba.py``: the port rounds each
op on its own, XLA fuses and contracts products and sums into FMAs, and
the reference's chunked scan composes the steps in another order than the
port's kernel route, which runs them one at a time. ``pytest -s`` prints
each gap as a share of the largest magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (decode_step, layers as L, loss_fn,
                                make_model, param_count, prefill)
from repro_torch.models.common import ParamInit, gelu

pytestmark = pytest.mark.usefixtures("one_thread")

RG = "recurrentgemma-2b"
LLAMA = "tinyllama-1.1b"
REL = 1e-4
ROUTES = {"chunked": {}, "kernel": {"rglru_kernel": True},
          "chunk16": {"scan_chunk": 16}}


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


def _make_pair(ref, arch, seed=0):
    rcfg = ref.configs.get_config(arch).scaled_down()
    rmodel = ref.api.make_model(rcfg)
    params = ref.jax.tree.map(np.asarray,
                              rmodel.init(ref.jax.random.key(seed)))
    model = make_model(get_config(arch).scaled_down(), seed=None,
                       device="cpu")
    model.load_state_dict(interop.model_state(params))
    return rmodel, params, model


@pytest.fixture(scope="module")
def rg(ref):
    return _make_pair(ref, RG)


@pytest.fixture(scope="module")
def llama(ref):
    return _make_pair(ref, LLAMA)


# ------------------------------------------------------------ parameters

def test_full_model_parameter_count(ref):
    """recurrentgemma-2b: 3,549,934,080 bf16 parameters (26 layers, 18
    RG-LRU and 8 local attention), counted on the meta device, as the
    reference's abstract params count them."""
    cfg = get_config(RG)
    model = make_model(cfg, seed=None, device="meta")
    theirs = ref.api.make_model(ref.configs.get_config(RG))
    assert param_count(model) == 3_549_934_080
    assert param_count(model) == sum(
        int(np.prod(x.shape))
        for x in ref.jax.tree.leaves(theirs.abstract_params()))
    assert [layer.kind for layer in model.layers].count("rglru") == 18
    assert [layer.kind for layer in model.layers].count("local") == 8
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_rglru_leaves_are_scoped_under_rec(ref, rg):
    """The reference's ``groups/b<i>/rec/<leaf>`` is the port's
    ``layers.<i>.rec.<leaf>``: ``model_state`` loads every leaf, and
    ``reference_leaves`` gives the reference's leaves back, key for key,
    in ``jax.tree.leaves`` order and bit for bit."""
    rmodel, params, model = rg
    state = model.state_dict()
    assert "layers.0.rec.lambda_p" in state and "layers.2.attn.wq" in state
    assert not any(k.startswith("layers.0.w_") for k in state)
    flat = ref.jax.tree_util.tree_flatten_with_path(params)[0]
    keys = ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in flat]
    leaves = interop.reference_leaves(model)
    assert [lf.key for lf in leaves] == keys
    assert "groups/b0/rec/w_a" in keys
    for lf, (_, want) in zip(leaves, flat):
        np.testing.assert_array_equal(lf.value().detach().numpy(),
                                      np.asarray(want))


def test_init_names_shapes_and_scales(ref):
    cfg = get_config(RG).scaled_down()
    model = make_model(cfg, seed=3, device="cpu")
    rmodel = ref.api.make_model(ref.configs.get_config(RG).scaled_down())
    theirs = interop.model_state(ref.jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), rmodel.abstract_params()))
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    w = cfg.lru_dim
    for name, scale in (("layers.0.rec.w_branch", cfg.d_model ** -0.5),
                        ("layers.1.rec.out_proj", w ** -0.5),
                        ("layers.0.rec.w_a", 0.02),
                        ("layers.1.rec.conv_w", 0.5),
                        ("layers.2.attn.wq", cfg.d_model ** -0.5)):
        std = float(state[name].std())
        assert abs(std / scale - 1) < 0.15, (name, std, scale)
    assert not state["layers.0.rec.b_a"].any()
    # lru_a: softplus(lambda) / 8 = -log u with u in [0.9, 0.999)
    lam = state["layers.1.rec.lambda_p"].double()
    u = torch.exp(-torch.nn.functional.softplus(lam) / 8.0)
    assert float(u.min()) >= 0.9 - 1e-6 and float(u.max()) <= 0.999 + 1e-6


def test_lru_a_in_bf16_rounds_as_the_reference(ref):
    """Computed in the parameter dtype: on the same u (the port's draw,
    rounded to bf16) the reference's formula gives the port's values
    within one bf16 ulp, and -inf in the same places (u rounded to 1)."""
    shape = (4096,)
    lam = ParamInit(torch.bfloat16, "cpu", torch.Generator().manual_seed(0))(
        shape, init="lru_a")
    u = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    u = (u * (0.999 - 0.9) + 0.9).to(torch.bfloat16)
    jnp = ref.jax.numpy
    ju = jnp.asarray(u.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jnp.log(jnp.exp(-jnp.log(ju) * 8.0) - 1.0)
                      .astype(jnp.float32))
    got = lam.float().numpy()
    assert lam.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert 0 < np.isinf(got).sum() < 0.05 * got.size
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2 ** -7)


def test_gelu_is_jaxs_tanh_form(ref):
    x = _rng(1).normal(size=(3, 7, 64)).astype(np.float32) * 3
    _close(gelu(torch.from_numpy(x)),
           ref.jax.nn.gelu(ref.jax.numpy.asarray(x)), rel=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((gelu(torch.from_numpy(x)) - erf).abs().max()) > 1e-4


# ------------------------------------------------------------ blocks

def _rec0(ref, params):
    """Layer 0's RG-LRU leaves, as the reference's jnp arrays."""
    return ref.jax.tree.map(lambda a: ref.jax.numpy.asarray(a[0]),
                            params["groups"]["b0"]["rec"])


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_rglru_apply_matches_reference(ref, rg, route, mode):
    """One RG-LRU block on a ragged sequence (S = 300, over one chunk of
    256) from a nonzero state (prefill) or from zeros (train), each port
    route against the reference's block. Serving through the kernel runs
    without gradients; training through it raises."""
    _, params, model = rg
    cfg = model.cfg
    rng = _rng(2, len(route), len(mode))
    w = cfg.lru_dim
    x = rng.normal(size=(2, 300, cfg.d_model)).astype(np.float32)
    cache = None
    if mode == "prefill":
        cache = {"conv": rng.normal(size=(2, 3, w)).astype(np.float32),
                 "h": (rng.normal(size=(2, w)) * 0.5).astype(np.float32)}
    jnp = ref.jax.numpy
    y_r, c_r = ref.layers.rglru_apply(
        ref.configs.get_config(RG).scaled_down(),
        _rec0(ref, params), jnp.asarray(x),
        cache=None if cache is None else ref.jax.tree.map(jnp.asarray, cache),
        mode=mode)
    t_cache = (None if cache is None
               else ref.jax.tree.map(torch.from_numpy, cache))
    flags = ROUTES[route]
    if route == "kernel" and mode == "train":
        with pytest.raises(NotImplementedError, match="no backward"):
            L.rglru_apply(cfg, model.layers[0].rec, torch.from_numpy(x),
                          cache=t_cache, mode=mode, flags=flags)
    with torch.no_grad() if route == "kernel" else torch.enable_grad():
        y_p, c_p = L.rglru_apply(cfg, model.layers[0].rec,
                                 torch.from_numpy(x), cache=t_cache,
                                 mode=mode, flags=flags)
    _close(y_p, y_r)
    _close(c_p["h"], c_r["h"])
    _close(c_p["conv"], c_r["conv"])


def test_rglru_apply_decode_step(ref, rg):
    _, params, model = rg
    cfg = model.cfg
    rng = _rng(3)
    w = cfg.lru_dim
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.normal(size=(3, 3, w)).astype(np.float32),
             "h": rng.normal(size=(3, w)).astype(np.float32)}
    jnp = ref.jax.numpy
    y_r, c_r = ref.layers.rglru_apply(
        ref.configs.get_config(RG).scaled_down(),
        _rec0(ref, params), jnp.asarray(x),
        cache=ref.jax.tree.map(jnp.asarray, cache), mode="decode")
    y_p, c_p = L.rglru_apply(cfg, model.layers[0].rec, torch.from_numpy(x),
                             cache=ref.jax.tree.map(torch.from_numpy,
                                                    cache),
                             mode="decode", flags={"rglru_kernel": True})
    _close(y_p, y_r)
    _close(c_p["h"], c_r["h"])
    _close(c_p["conv"], c_r["conv"])


@pytest.mark.parametrize("case", ["padded", "ring"])
@pytest.mark.parametrize("kind", ["local", "global"])
def test_attention_prefill_and_decode_match_reference(ref, rg, kind, case):
    """One attention block (recurrentgemma's, 1 KV head) on a prompt of 80
    tokens (over the 64-token window), then 6 decode steps from its cache:
    ``cache_len`` 89 pads the cache (``padded``); 40 < S keeps the last 40
    keys in their ring slots and decode wraps the ring (``ring``)."""
    _, params, model = rg
    cfg = model.cfg
    rcfg = ref.configs.get_config(RG).scaled_down()
    jnp = ref.jax.numpy
    p_r = ref.jax.tree.map(lambda a: jnp.asarray(a[0]),
                           params["groups"]["b2"]["attn"])
    p_t = model.layers[2].attn
    cache_len = 89 if case == "padded" else 40
    rng = _rng(4, len(kind), len(case))
    B, S = 2, 80
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    fl = {"cache_len": cache_len}
    y_r, c_r = ref.layers.attention_apply(
        rcfg, p_r, jnp.asarray(x), jnp.asarray(pos), kind=kind,
        mode="prefill", flags=fl)
    with torch.no_grad():
        y_p, c_p = L.attention_apply(
            cfg, p_t, torch.from_numpy(x), torch.from_numpy(pos.copy()),
            kind=kind, mode="prefill", flags=fl)
        _close(y_p, y_r)
        for k in ("k", "v"):
            _close(c_p[k], c_r[k])
        np.testing.assert_array_equal(c_p["pos"].numpy(),
                                      np.asarray(c_r["pos"]))
        assert c_p["pos"].dtype == torch.int32
        for i in range(6):
            xi = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
            pi = np.full((B, 1), S + i, np.int32)
            y_r, c_r = ref.layers.attention_apply(
                rcfg, p_r, jnp.asarray(xi), jnp.asarray(pi), kind=kind,
                cache=c_r, mode="decode")
            old = {k: v.clone() for k, v in c_p.items()}
            y_p, c_p = L.attention_apply(
                cfg, p_t, torch.from_numpy(xi), torch.from_numpy(pi).long(),
                kind=kind, cache=c_p, mode="decode")
            _close(y_p, y_r)
            np.testing.assert_array_equal(c_p["pos"].numpy(),
                                          np.asarray(c_r["pos"]))
            _close(c_p["k"], c_r["k"])
            # the caller's cache is not written in place
            assert int((old["pos"] != c_p["pos"]).sum()) == B
    slot = (S + 5) % cache_len
    assert int(c_p["pos"][0, slot]) == S + 5


def test_chunked_attention_raises(ref, rg):
    """recurrentgemma's local attention block (layer 2) on the chunked
    route: a prefill of 2 x 80 tokens into a 40-slot ring and 3 decode
    steps, against the reference's chunked route; and the bidirectional
    encoder kind, which raised here until the front ends were ported, on
    the same block from a chunked caller (2 x 3 tokens) against the
    reference's."""
    _, params, model = rg
    cfg = model.cfg
    rcfg = ref.configs.get_config(RG).scaled_down()
    jnp = ref.jax.numpy
    p_r = ref.jax.tree.map(lambda a: jnp.asarray(a[0]),
                           params["groups"]["b2"]["attn"])
    p_t = model.layers[2].attn
    rng = _rng(7)
    B, S = 2, 80
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    fl = {"cache_len": 40, "attn_impl": "chunked"}
    y_r, c_r = ref.layers.attention_apply(
        rcfg, p_r, jnp.asarray(x), jnp.asarray(pos), kind="local",
        mode="prefill", flags=fl)
    with torch.no_grad():
        y_p, c_p = L.attention_apply(
            cfg, p_t, torch.from_numpy(x), torch.from_numpy(pos.copy()),
            kind="local", mode="prefill", flags=fl)
        _close(y_p, y_r)
        for i in range(3):
            xi = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
            pi = np.full((B, 1), S + i, np.int32)
            y_r, c_r = ref.layers.attention_apply(
                rcfg, p_r, jnp.asarray(xi), jnp.asarray(pi), kind="local",
                cache=c_r, mode="decode", flags=fl)
            y_p, c_p = L.attention_apply(
                cfg, p_t, torch.from_numpy(xi), torch.from_numpy(pi).long(),
                kind="local", cache=c_p, mode="decode", flags=fl)
            _close(y_p, y_r)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, dtype=np.int32), (2, 3))
    fl = {"attn_impl": "chunked"}
    y_r, _ = ref.layers.attention_apply(
        rcfg, p_r, jnp.asarray(x), jnp.asarray(pos), kind="encoder",
        flags=fl)
    with torch.no_grad():
        y_p, _ = L.attention_apply(
            cfg, p_t, torch.from_numpy(x), torch.from_numpy(pos.copy()),
            kind="encoder", flags=fl)
    _close(y_p, y_r)


# ------------------------------------------------------------ models

def _cache_leaves(caches, P):
    """Port caches (one dict per layer) -> {(group, block, kind, leaf):
    tensor}, the reference's stacked layout, for comparison."""
    out = {}
    for i, c in enumerate(caches):
        (kind, leaves), = c.items()
        for name, v in leaves.items():
            out[(i // P, i % P, kind, name)] = v
    return out


def _check_caches(caches, r_caches, P):
    for (g, blk, kind, name), v in _cache_leaves(caches, P).items():
        want = np.asarray(r_caches["groups"][f"b{blk}"][kind][name])[g]
        if name == "pos":
            np.testing.assert_array_equal(v.numpy(), want)
        else:
            _close(v, want)


def _reference_serve(ref, pair, tokens, feed, cache_len, flags=None):
    rmodel, params, _ = pair
    jnp = ref.jax.numpy
    jparams = ref.jax.tree.map(jnp.asarray, params)
    logits, caches, _ = ref.api.prefill(
        rmodel, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        cache_len, flags)
    out, pre_caches = [np.asarray(logits)], caches
    for i in range(feed.shape[1]):
        pos = jnp.full((tokens.shape[0],), tokens.shape[1] + i, jnp.int32)
        logits, caches = ref.api.decode_step(
            rmodel, jparams, jnp.asarray(feed[:, i:i + 1], jnp.int32), pos,
            caches, flags=flags)
        out.append(np.asarray(logits))
    return out, pre_caches, caches


@pytest.mark.parametrize("case", ["window", "ring"])
@pytest.mark.parametrize("arch", [RG, LLAMA])
def test_prefill_and_decode_match_reference(ref, rg, llama, arch, case):
    """Prefill logits and caches of 2 x 80 prompt tokens (over the
    scaled-down 64-token window), then 8 decode steps fed the same tokens,
    against ``repro.models.api``; ``window``: cache_len 89 (every layer's
    cache 89 long, as the reference pads a local layer's too); ``ring``:
    cache_len 40 < S (the ring scatter; decode wraps the ring). The port
    runs its serve flags (the RG-LRU on the kernel route)."""
    pair = rg if arch == RG else llama
    _, _, model = pair
    cfg = model.cfg
    P = len(cfg.layer_pattern)
    cache_len = 89 if case == "window" else 40
    rng = _rng(5, len(arch), len(case))
    tokens = rng.integers(0, cfg.vocab_size, (2, 80))
    feed = rng.integers(0, cfg.vocab_size, (2, 8))
    want, r_pre, r_post = _reference_serve(ref, pair, tokens, feed,
                                           cache_len)
    flags = serve_mod.SERVE_FLAGS
    logits, caches, memory = prefill(model, {"tokens": torch.from_numpy(
        tokens)}, cache_len, flags)
    assert memory is None
    _close(logits, want[0])
    _check_caches(caches, r_pre, P)
    for i in range(8):
        logits, caches = decode_step(
            model, torch.from_numpy(feed[:, i:i + 1]),
            torch.full((2,), 80 + i), caches, flags=flags)
        _close(logits, want[i + 1])
    _check_caches(caches, r_post, P)
    for c in caches:
        if "attn" in c:
            assert c["attn"]["k"].shape[1] == cache_len


def test_prefill_launches_the_scan_once_per_rglru_layer(rg, monkeypatch):
    """The serve flags send each RG-LRU layer's prefill recurrence to
    ``kernels.ops.linear_scan`` (one call a layer, contiguous f32 inputs)
    and decode to none: the launches the card counts."""
    _, _, model = rg
    calls = []
    real = kops.linear_scan

    def spy(a, b, h0, *, use_kernel=True):
        calls.append((tuple(a.shape), a.is_contiguous(), b.is_contiguous(),
                      a.dtype, use_kernel))
        return real(a, b, h0, use_kernel=use_kernel)

    monkeypatch.setattr(kops, "linear_scan", spy)
    out = serve_mod.serve(model, batch=2, prompt_len=70, tokens=3)
    assert calls == [((2, 70, model.cfg.lru_dim), True, True,
                      torch.float32, True)] * 2
    assert sum(out.prefill_launches.values()) == 0     # CPU: plain version
    assert sum(out.decode_launches.values()) == 0


def test_serve_loop_on_recurrentgemma(rg):
    """The request loop: fed its own tokens it gives the same logits on
    the kernel and chunked routes within the tolerance, and the last
    decode step equals one longer prefill's last logits."""
    _, _, model = rg
    a = serve_mod.serve(model, batch=2, prompt_len=70, tokens=5,
                        keep_logits=True)
    b = serve_mod.serve(model, batch=2, prompt_len=70, tokens=5,
                        keep_logits=True, feed=a.generated, flags={})
    assert torch.equal(a.generated, b.generated)
    _close(a.decode_logits, b.decode_logits.numpy())
    assert torch.isfinite(a.decode_logits).all()
    full = torch.cat([a.prompt, a.generated[:, :-1]], dim=1)
    last, _, _ = prefill(model, {"tokens": full}, full.shape[1],
                         serve_mod.SERVE_FLAGS)
    _close(a.decode_logits[-1], last.numpy())


def test_loss_matches_reference_and_kernel_route_refuses_training(ref, rg):
    """recurrentgemma trains on the chunked route (its loss against the
    reference's); asking for the kernel route with gradients raises."""
    rmodel, params, model = rg
    tokens = _rng(6).integers(0, model.cfg.vocab_size, (2, 70))
    jnp = ref.jax.numpy
    want, _ = ref.api.loss_fn(rmodel, ref.jax.tree.map(jnp.asarray, params),
                              {"tokens": jnp.asarray(tokens, jnp.int32)})
    loss, _ = loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="no backward"):
        loss_fn(model, {"tokens": torch.from_numpy(tokens)},
                flags={"rglru_kernel": True})


def test_init_cache_per_kind(rg):
    _, _, model = rg
    cfg = model.cfg
    caches = model.init_cache(3, 100)
    assert [next(iter(c)) for c in caches] == ["rec", "rec", "attn"]
    assert caches[0]["rec"]["h"].shape == (3, cfg.lru_dim)
    assert caches[0]["rec"]["h"].dtype == torch.float32
    assert caches[1]["rec"]["conv"].shape == (3, cfg.conv1d_width - 1,
                                              cfg.lru_dim)
    att = caches[2]["attn"]
    assert att["k"].shape == (3, cfg.window_size, cfg.n_kv_heads, cfg.hd)
    assert bool((att["pos"] == -1).all())
    glob = make_model(dataclasses.replace(cfg, layer_pattern=("global",)),
                      device="cpu").init_cache(1, 100)
    assert glob[0]["attn"]["k"].shape[1] == 100


def test_serve_cli_on_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--arch", RG, "--tokens", "3",
                    "--batch", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert f"[{RG}] prefill(2x8)" in out
    assert "decoded 3 tokens x 2 requests" in out
