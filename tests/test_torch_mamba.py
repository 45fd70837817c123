"""The port's Mamba-1 model (``repro_torch.models``) on the CPU against the
JAX reference (``repro.models``) at falcon-mamba-7b's ``scaled_down()``
sizes in f32 (2 layers, d_model 128, d_inner 256, n 8, vocab 512), with the
reference's weights carried across by ``repro_torch.interop.model_state``
and the same numpy-made inputs.

Tolerance: every tensor within rtol 1e-4 plus 1e-4 of its largest
magnitude (``_close``), the 1e-4 of the reference's own
``test_mamba_kernel_flag_matches_jnp``. The port rounds each op on its
own; XLA fuses, contracts products and sums into FMAs, and runs its
associative scans in another order, which moves entries near zero by more
than a pure relative bound would allow. ``pytest -s`` prints each gap
as a share of the largest magnitude.

bf16 is not compared here: XLA computes a fused bf16 chain in f32 and
rounds once, torch rounds after every op. On the card the kernel is held
bit-equal to its plain version in bf16 models by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, REGISTRY, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import (decode_step, layers as L, make_batch,
                                make_model, param_count, prefill)
from repro_torch.models.common import ParamInit, rms_norm

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "falcon-mamba-7b"
REL = 1e-4
ROUTES = {"fused": {}, "kernel": {"mamba_kernel": True},
          "materialised": {"mamba_fused": False},
          "fused-chunk16": {"scan_chunk": 16}}


def _close(port, want, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    want = np.asarray(want)
    assert port.shape == want.shape, (port.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(port, want, rtol=rel, atol=rel * scale)
    if scale:
        print(f"gap {np.max(np.abs(port - want)) / scale:.3g} of the "
              f"largest magnitude")


@pytest.fixture(scope="module")
def pair(ref):
    """(reference model, its params, port model) with the same weights."""
    rcfg = ref.configs.get_config(ARCH).scaled_down()
    rmodel = ref.api.make_model(rcfg)
    params = rmodel.init(ref.jax.random.key(0))
    model = make_model(get_config(ARCH).scaled_down(), seed=None,
                       device="cpu")
    model.load_state_dict(interop.model_state(
        ref.jax.tree.map(np.asarray, params)))
    return rmodel, params, model


def _layer0(ref, params):
    return ref.jax.tree.map(lambda a: a[0], params["groups"]["b0"]["mamba"])


def _rng(*key):
    return np.random.default_rng(list(key))


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(ref, arch):
    mine, theirs = get_config(arch), ref.configs.get_config(arch)
    for f in dataclasses.fields(mine):
        if f.name != "dtype":
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.dtype == torch.bfloat16
    assert str(theirs.dtype.dtype) == "bfloat16"
    small, rsmall = mine.scaled_down(), theirs.scaled_down()
    assert small.dtype == torch.float32
    for f in dataclasses.fields(small):
        if f.name != "dtype":
            assert getattr(small, f.name) == getattr(rsmall, f.name), f.name
    for prop in ("hd", "d_inner", "dt_rank", "lru_dim"):
        assert getattr(mine, prop) == getattr(theirs, prop)
    assert [mine.kind(i) for i in range(mine.n_layers)] == \
        [theirs.kind(i) for i in range(theirs.n_layers)]
    assert set(REGISTRY) == set(ref.configs.REGISTRY)


def test_full_model_parameter_count(ref):
    """7,272,665,088 parameters, counted on the meta device (nothing is
    allocated), as the reference's abstract params count them."""
    cfg = get_config(ARCH)
    model = make_model(cfg, seed=None, device="meta")
    theirs = ref.api.make_model(ref.configs.get_config(ARCH))
    assert param_count(model) == 7_272_665_088
    assert param_count(model) == sum(
        int(np.prod(x.shape))
        for x in ref.jax.tree.leaves(theirs.abstract_params()))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert len(model.layers) == 64


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != ARCH])
def test_other_kinds_raise_not_implemented(arch):
    """Every other arch at its scaled-down sizes builds (the audio and VLM
    front ends too, which raised here until they were ported), and its
    prefill of 2 x 80 tokens (over the 64-token window; whisper's with
    its frames, internvl2's with its patches in front) on the chunked
    attention equals the einsum route's within the tolerance."""
    cfg = get_config(arch).scaled_down()
    model = make_model(cfg, device="cpu")
    batch = make_batch(cfg, 2, 80, torch.Generator().manual_seed(1))
    want, _, _ = prefill(model, batch, 84)
    got, _, _ = prefill(model, batch, 84, {"attn_impl": "chunked"})
    _close(got, want.numpy())


def _unported_call(block):
    """(a call of what the port does not run, the message it raises):
    the MoE block's expert-parallel route inside a manual shard
    (multi-card, item 10 step 6); the RG-LRU's kernel route under
    autograd (the kernel has no backward). Cross-attention and the
    bidirectional encoder kind (the front ends, item 10 step 4) raised
    until they were ported: their calls now run, and the message is
    None."""
    if block == "rglru_apply":
        model = make_model(get_config("recurrentgemma-2b").scaled_down(),
                           device="cpu")
        x = torch.zeros(1, 4, model.cfg.d_model)
        return (lambda: L.rglru_apply(model.cfg, model.layers[0].rec, x,
                                      flags={"rglru_kernel": True}),
                "no backward")
    if block == "moe_apply_ep":
        model = make_model(get_config("qwen3-moe-30b-a3b").scaled_down(),
                           device="cpu")
        x = torch.zeros(1, 4, model.cfg.d_model)
        return (lambda: L.moe_apply(model.cfg, model.layers[0].moe, x,
                                    flags={"moe_impl": "ep",
                                           "_in_manual": True}),
                "ROADMAP Queue 1 item 10 step 6")
    model = make_model(get_config("tinyllama-1.1b").scaled_down(),
                       device="cpu")
    x = torch.zeros(1, 4, model.cfg.d_model)
    kw = {"cross_attention": dict(cross_kv=x),
          "encoder_attention": dict(kind="encoder")}[block]
    return (lambda: L.attention_apply(model.cfg, model.layers[0].attn, x,
                                      torch.arange(4)[None], **kw),
            None)


@pytest.mark.parametrize("block", ["cross_attention", "encoder_attention",
                                   "moe_apply_ep", "rglru_apply"])
def test_unported_blocks_raise(block):
    """What the port does not run raises; the front ends' blocks run and
    give finite (1, 4, d) outputs."""
    call, match = _unported_call(block)
    if match is None:
        y, cache = call()
        assert y.shape == (1, 4, 128) and bool(torch.isfinite(y).all())
        assert cache is None
        return
    with pytest.raises(NotImplementedError, match=match):
        call()


def test_default_device_is_the_card():
    """``device=None`` means the card; without one it raises rather than
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_model(get_config(ARCH).scaled_down())


# ------------------------------------------------------------ init

def test_init_names_shapes_and_scales(ref):
    """The port's parameter tree is the reference's, leaf for leaf; the
    draws have the reference's scales and the fixed leaves its values."""
    cfg = get_config(ARCH).scaled_down()
    model = make_model(cfg, seed=3, device="cpu")
    rmodel = ref.api.make_model(ref.configs.get_config(ARCH).scaled_down())
    state = model.state_dict()
    theirs = interop.model_state(ref.jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), rmodel.abstract_params()))
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    d, di = cfg.d_model, cfg.d_inner
    for name, scale in (("embed", 0.02), ("lm_head", 0.02),
                        ("layers.0.mamba.in_proj", d ** -0.5),
                        ("layers.1.mamba.out_proj", di ** -0.5),
                        ("layers.0.mamba.conv_w", 0.5)):
        std = float(state[name].std())
        assert abs(std / scale - 1) < 0.1, (name, std, scale)
    assert torch.equal(state["layers.1.mamba.d_skip"], torch.ones(di))
    assert not state["layers.0.mamba.dt_bias"].any()
    assert torch.equal(state["final_norm"], torch.ones(d))
    a_log = ref.jax.tree.map(np.asarray, ref.api.make_model(
        ref.configs.get_config(ARCH).scaled_down()).init(
            ref.jax.random.key(1)))["groups"]["b0"]["mamba"]["a_log"][0]
    # f32 log(7) is one ulp apart in torch's and XLA's CPU log
    np.testing.assert_array_max_ulp(state["layers.0.mamba.a_log"].numpy(),
                                    a_log, maxulp=1)


def test_ssm_a_in_bf16_matches_reference(ref):
    """The full config's A is log(1..16) computed in bf16."""
    jnp = ref.jax.numpy
    theirs = np.asarray(jnp.log(jnp.tile(
        jnp.arange(1, 17, dtype=jnp.bfloat16), (8, 1))).astype(jnp.float32))
    mine = ParamInit(torch.bfloat16, "cpu", torch.Generator())((8, 16),
                                                               init="ssm_a")
    assert mine.dtype == torch.bfloat16
    np.testing.assert_array_equal(mine.float().numpy(), theirs)


def test_generator_makes_the_weights():
    cfg = get_config(ARCH).scaled_down()
    a, b, c = (make_model(cfg, seed=s, device="cpu") for s in (5, 5, 6))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.embed, c.embed)


# ------------------------------------------------------------ blocks

def test_rms_norm_matches_reference(ref):
    x = _rng(1).normal(size=(3, 5, 128)).astype(np.float32) * 3
    w = _rng(2).normal(size=128).astype(np.float32)
    theirs = ref.common.rms_norm(ref.jax.numpy.asarray(x),
                                 ref.jax.numpy.asarray(w), 1e-6)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), theirs)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(ref, with_state):
    rng = _rng(3, int(with_state))
    x = rng.normal(size=(2, 37, 256)).astype(np.float32)
    w = rng.normal(size=(4, 256)).astype(np.float32) * 0.5
    bias = rng.normal(size=256).astype(np.float32)
    state = (rng.normal(size=(2, 3, 256)).astype(np.float32)
             if with_state else None)
    jnp = ref.jax.numpy
    y_r, s_r = ref.layers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if state is None else jnp.asarray(state))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y_p, s_p = L.causal_conv1d(t(x), t(w), t(bias), t(state))
    _close(y_p, y_r)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))


@pytest.mark.parametrize("route", list(ROUTES))
def test_mamba_apply_prefill_routes(ref, pair, route):
    """One Mamba block on a ragged sequence (S = 37) from a nonzero state,
    each route against the reference's same route (its kernel route runs
    the Pallas scan in interpret mode)."""
    _, params, model = pair
    cfg = model.cfg
    rng = _rng(4, len(route))
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, 3, cfg.d_inner)).astype(np.float32)
    h0 = (rng.normal(size=(2, cfg.d_inner, cfg.ssm_state)) * 0.1).astype(
        np.float32)
    jnp = ref.jax.numpy
    y_r, c_r = ref.layers.mamba_apply(
        ref.configs.get_config(ARCH).scaled_down(), _layer0(ref, params),
        jnp.asarray(x), cache={"conv": jnp.asarray(conv), "h": jnp.asarray(h0)},
        mode="prefill", flags=ROUTES[route])
    with torch.no_grad():              # a prefill serves: no gradients
        y_p, c_p = L.mamba_apply(
            cfg, model.layers[0].mamba, torch.from_numpy(x),
            cache={"conv": torch.from_numpy(conv), "h": torch.from_numpy(h0)},
            mode="prefill", flags=ROUTES[route])
    _close(y_p, y_r)
    _close(c_p["h"], c_r["h"])
    _close(c_p["conv"], c_r["conv"])   # the in_proj product's last rows


def test_mamba_apply_decode_route(ref, pair):
    _, params, model = pair
    cfg = model.cfg
    rng = _rng(5)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, 3, cfg.d_inner)).astype(np.float32)
    h0 = rng.normal(size=(3, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    jnp = ref.jax.numpy
    y_r, c_r = ref.layers.mamba_apply(
        ref.configs.get_config(ARCH).scaled_down(), _layer0(ref, params),
        jnp.asarray(x), cache={"conv": jnp.asarray(conv), "h": jnp.asarray(h0)},
        mode="decode")
    y_p, c_p = L.mamba_apply(
        cfg, model.layers[0].mamba, torch.from_numpy(x),
        cache={"conv": torch.from_numpy(conv), "h": torch.from_numpy(h0)},
        mode="decode")
    _close(y_p, y_r)
    _close(c_p["h"], c_r["h"])
    _close(c_p["conv"], c_r["conv"])   # the in_proj product's last rows


def test_linear_scan_chunked_matches_reference(ref):
    rng = _rng(6)
    a = rng.uniform(0.5, 1.0, (2, 300, 3, 5)).astype(np.float32)
    b = rng.normal(size=(2, 300, 3, 5)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 5)).astype(np.float32)
    jnp = ref.jax.numpy
    h_r, l_r = ref.layers.linear_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(h0), chunk=128)
    h_p, l_p = L.linear_scan_chunked(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(h0), chunk=128)
    _close(h_p, h_r)
    _close(l_p, l_r)


# ------------------------------------------------------------ model

def _reference_serve(ref, pair, flags, tokens, feed):
    rmodel, params, _ = pair
    jnp = ref.jax.numpy
    logits, caches, _ = ref.api.prefill(
        rmodel, params, {"tokens": jnp.asarray(tokens, jnp.int32)},
        tokens.shape[1] + feed.shape[1], flags)
    out = [np.asarray(logits)]
    h = [np.asarray(caches["groups"]["b0"]["mamba"]["h"])]
    conv = [np.asarray(caches["groups"]["b0"]["mamba"]["conv"])]
    for i in range(feed.shape[1] - 1):
        pos = jnp.full((tokens.shape[0],), tokens.shape[1] + i, jnp.int32)
        logits, caches = ref.api.decode_step(
            rmodel, params, jnp.asarray(feed[:, i:i + 1], jnp.int32), pos,
            caches, flags=flags)
        out.append(np.asarray(logits))
    return out, h[0], conv[0]


@pytest.mark.parametrize("route", ["kernel", "fused"])
def test_prefill_and_decode_match_reference(ref, pair, route):
    """Prefill logits and caches, then 4 decode steps fed the same tokens,
    through the serve steps, against ``repro.models.api``."""
    _, _, model = pair
    cfg = model.cfg
    flags = ROUTES[route]
    rng = _rng(7, len(route))
    tokens = rng.integers(0, cfg.vocab_size, (2, 32))
    feed = rng.integers(0, cfg.vocab_size, (2, 5))
    want, h_r, conv_r = _reference_serve(ref, pair, flags, tokens, feed)
    pre = make_prefill_step(model, batch=2, seq=32, cache_len=37,
                            flags=flags)
    dec = make_decode_step(model, batch=2, cache_len=37, flags=flags)
    logits, caches, memory = pre({"tokens": torch.from_numpy(tokens)})
    assert memory is None
    _close(logits, want[0])
    _close(torch.stack([c["mamba"]["h"] for c in caches]), h_r)
    _close(torch.stack([c["mamba"]["conv"] for c in caches]), conv_r)
    for i in range(4):
        logits, caches = dec(torch.from_numpy(feed[:, i:i + 1]),
                             torch.full((2,), 32 + i), caches, memory)
        _close(logits, want[i + 1])


def test_serve_loop_feeds_and_samples(pair):
    """The request loop: fed another run's tokens it reproduces that run's
    logits; sampling is repeatable from its seed; the steps check shapes."""
    _, _, model = pair
    a = serve_mod.serve(model, batch=2, prompt_len=12, tokens=5,
                        keep_logits=True)
    b = serve_mod.serve(model, batch=2, prompt_len=12, tokens=5,
                        keep_logits=True, feed=a.generated)
    c = serve_mod.serve(model, batch=2, prompt_len=12, tokens=5)
    assert a.generated.shape == (2, 6) and a.decode_logits.shape == (
        5, 2, model.cfg.vocab_size)
    assert torch.equal(a.generated, b.generated)
    assert torch.equal(a.generated, c.generated)
    assert torch.equal(a.decode_logits, b.decode_logits)
    assert torch.equal(a.generated[:, 0], torch.argmax(a.prefill_logits, -1))
    assert torch.isfinite(a.decode_logits).all()
    # CPU tensors take the plain scan, which counts no launch
    assert a.prefill_launches["selective_scan"] == 0
    assert sum(a.decode_launches.values()) == 0
    # prefill + decode equals one longer prefill's last logits
    full = torch.cat([a.prompt, a.generated[:, :-1]], dim=1)
    last, _, _ = prefill(model, {"tokens": full}, full.shape[1],
                         serve_mod.SERVE_FLAGS)
    _close(a.decode_logits[-1], last.numpy(), rel=1e-5)
    with pytest.raises(ValueError):
        make_prefill_step(model, batch=3, seq=12)({"tokens": a.prompt})


def test_decode_step_api_and_batch(pair):
    _, _, model = pair
    gen = torch.Generator().manual_seed(0)
    batch = make_batch(model.cfg, 3, 8, gen)
    assert batch["tokens"].shape == (3, 8)
    assert int(batch["tokens"].max()) < model.cfg.vocab_size
    logits, caches, _ = prefill(model, batch, 9)
    logits2, caches2 = decode_step(model, batch["tokens"][:, -1:],
                                   torch.full((3,), 8), caches)
    assert logits.shape == logits2.shape == (3, model.cfg.vocab_size)
    assert len(caches2) == model.cfg.n_layers
    assert caches2[0]["mamba"]["h"].dtype == torch.float32


def test_serve_cli_on_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--tokens", "3", "--batch", "2",
                    "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "[falcon-mamba-7b] prefill(2x8)" in out
    assert "decoded 3 tokens x 2 requests" in out
