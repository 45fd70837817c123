"""The port's VLM front end (``repro_torch.models``: the patch prefix in
front of the text, its loss mask, prefill and decode positions) on the
CPU against the JAX reference at internvl2-2b's ``scaled_down()`` sizes
in f32 (2 layers, d_model 128, 4 heads / 4 KV heads of 32, d_ff 256,
vocab 512, 8 patches), with the reference's weights carried across by
``repro_torch.interop.model_state`` and the same numpy-made inputs; and
the inputs of every arch (``batch_spec``, ``make_batch``), ``serve``'s
cache length and decode positions against ``examples/serve.py``'s, and
the launcher's refusal of the front ends.

Tolerances: the loss, every gradient leaf and the logits within 1e-4 of
the reference's largest magnitude (plus 1e-4 relative); shapes, counts
and positions exact.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (batch_spec, decode_step, loss_fn,
                                make_batch, make_model, param_count,
                                prefill)

ARCH = "internvl2-2b"
REL = 1e-4
ROUTES = ("einsum", "chunked")


pytestmark = pytest.mark.usefixtures("one_thread")

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
def pair(ref):
    """(reference model, its params as numpy, port model)."""
    rmodel = ref.api.make_model(ref.configs.get_config(ARCH).scaled_down())
    params = ref.jax.tree.map(np.asarray, rmodel.init(ref.jax.random.key(1)))
    model = make_model(get_config(ARCH).scaled_down(), seed=None,
                       device="cpu")
    model.load_state_dict(interop.model_state(params))
    return rmodel, params, model


def _batch(cfg, rng, batch, text):
    """numpy tokens (B, text) and patches (B, vision_prefix, d)."""
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, text)),
            "patches": rng.standard_normal(
                (batch, cfg.vision_prefix, cfg.d_model)).astype(np.float32)}


def _ref_batch(ref, b):
    jnp = ref.jax.numpy
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "patches": jnp.asarray(b["patches"])}


def _port_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]),
            "patches": torch.from_numpy(b["patches"])}


def test_loss_and_grads_match_reference(ref, pair):
    """``loss_fn`` on 2 x (8 patches + 20 text tokens): the loss over the
    text positions and the gradient of each of the 12 reference leaves
    within 1e-4."""
    rmodel, params, model = pair
    jax = ref.jax
    b = _batch(model.cfg, _rng(1), 2, 20)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref.api.loss_fn(rmodel, p, _ref_batch(ref, b)),
        has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, _port_batch(b))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=REL)
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    leaves = interop.reference_leaves(model)
    assert len(leaves) == 12
    assert [lf.key for lf in leaves] == [
        "/".join(str(q.key) for q in path) for path, _ in flat]
    for leaf, (_, g) in zip(leaves, flat):
        _close(leaf.value(lambda p: p.grad), g)
    model.zero_grad(set_to_none=True)


def test_single_text_token_batch_has_zero_loss(ref, pair):
    """ROADMAP Queue 3: a VLM batch of one text token (``make_batch`` at a
    sequence no longer than the prefix gives one) has no next-token
    target, so its loss is exactly 0 in both packages, and the port's
    gradients are all zero."""
    rmodel, params, model = pair
    cfg = model.cfg
    tb = make_batch(cfg, 2, cfg.vision_prefix - 3,
                    torch.Generator().manual_seed(2))
    assert tuple(tb["tokens"].shape) == (2, 1)
    b = {"tokens": tb["tokens"].numpy(), "patches": tb["patches"].numpy()}
    want, _ = ref.api.loss_fn(rmodel, params, _ref_batch(ref, b))
    assert float(want) == 0.0
    model.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, tb)
    assert float(loss.detach()) == 0.0 == float(metrics["ce"].detach())
    loss.backward()
    assert all(p.grad is None or not bool(p.grad.any())
               for p in model.parameters())
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("impl", ROUTES)
def test_prefill_and_decode_match_reference(ref, pair, impl):
    """Prefill of 2 x (8 patches + 16 text tokens) into a 28-slot cache,
    then 3 decode steps fed the same tokens at positions 24, 25, 26 (the
    text tokens plus the prefix), on each attention route: logits within
    1e-4; the port returns no memory."""
    rmodel, params, model = pair
    jnp = ref.jax.numpy
    jparams = ref.jax.tree.map(jnp.asarray, params)
    fl = {"attn_impl": impl}
    rng = _rng(3, len(impl))
    b = _batch(model.cfg, rng, 2, 16)
    feed = rng.integers(0, model.cfg.vocab_size, (2, 3))
    want, r_caches, _ = ref.api.prefill(rmodel, jparams, _ref_batch(ref, b),
                                        28, fl)
    got, caches, memory = prefill(model, _port_batch(b), 28, fl)
    assert memory is None
    _close(got, want)
    for i in range(3):
        pos = np.full((2,), 24 + i, np.int32)
        want, r_caches = ref.api.decode_step(
            rmodel, jparams, jnp.asarray(feed[:, i:i + 1], jnp.int32),
            jnp.asarray(pos), r_caches, flags=fl)
        got, caches = decode_step(
            model, torch.from_numpy(feed[:, i:i + 1]),
            torch.from_numpy(pos).long(), caches, flags=fl)
        _close(got, want)


def test_parameter_count_and_leaves_at_full_size(ref):
    """1,889,146,880 bf16 parameters in 12 reference leaves, counted on
    the meta device against the reference's abstract params."""
    model = make_model(get_config(ARCH), seed=None, device="meta")
    abstract = ref.api.make_model(
        ref.configs.get_config(ARCH)).abstract_params()
    flat = ref.jax.tree_util.tree_flatten_with_path(abstract)[0]
    assert (param_count(model) == 1_889_146_880
            == ref.api.param_count(abstract))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert [(lf.key, lf.shape) for lf in interop.reference_leaves(model)] \
        == [("/".join(str(q.key) for q in path), x.shape)
            for path, x in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_spec_and_make_batch_match_reference(ref, arch):
    """Every arch's inputs at full and scaled-down sizes, at 2 x 40, 2 x 5
    and 2 x 500 (a VLM's text: max(s - prefix, 1); whisper's 448-token
    cap): the
    names and shapes of the reference's ``batch_spec``; ``make_batch``'s
    tokens in range, embeddings in the config's dtype, the tokens the
    same draws as a text batch's."""
    jnp = ref.jax.numpy
    for cfg, rcfg in ((get_config(arch), ref.configs.get_config(arch)),
                      (get_config(arch).scaled_down(),
                       ref.configs.get_config(arch).scaled_down())):
        for seq in (40, 5, 500):
            want = ref.api.batch_spec(rcfg, 2, seq)
            spec = batch_spec(cfg, 2, seq)
            assert {k: shape for k, (shape, _) in spec.items()} == {
                k: tuple(v.shape) for k, v in want.items()}
            for k, (_, dt) in spec.items():
                assert (dt == torch.int64 if k == "tokens"
                        else str(dt).split(".")[-1]
                        == jnp.dtype(want[k].dtype).name)
        got = make_batch(cfg, 2, 40, torch.Generator().manual_seed(4))
        assert all(v.dtype == (torch.int64 if k == "tokens" else cfg.dtype)
                   for k, v in got.items())
        toks = got["tokens"]
        assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
        text = torch.randint(0, cfg.vocab_size, tuple(toks.shape),
                             generator=torch.Generator().manual_seed(4))
        assert torch.equal(toks, text)


@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny", "tinyllama-1.1b"])
def test_serve_cache_len_and_positions_match_example(monkeypatch, arch):
    """``serve`` sizes its caches and places its decode positions as
    ``examples/serve.py`` does: cache_len = prompt_len + vision_prefix +
    tokens + 1 (prompt_len after ``effective_seq``: whisper's decoder
    stops at 448), the first decode at the text tokens plus the prefix;
    the VLM's prefill covers the prefix too."""
    cfg = get_config(arch).scaled_down()
    model = make_model(cfg, device="cpu")
    seen = {"positions": []}
    real_prefill, real_decode = (serve_mod.make_prefill_step,
                                 serve_mod.make_decode_step)

    def prefill_step(model, **kw):
        seen["prefill_cache_len"] = kw["cache_len"]
        return real_prefill(model, **kw)

    def decode_step_(model, **kw):
        seen["decode_cache_len"] = kw["cache_len"]
        fn = real_decode(model, **kw)

        def decode(token, position, caches, memory=None):
            seen["positions"].append(position.tolist())
            seen["cache_slots"] = caches[0]["attn"]["k"].shape[1]
            seen["memory"] = memory
            return fn(token, position, caches, memory)
        return decode

    monkeypatch.setattr(serve_mod, "make_prefill_step", prefill_step)
    monkeypatch.setattr(serve_mod, "make_decode_step", decode_step_)
    prompt_len = 460 if arch == "whisper-tiny" else 20
    out = serve_mod.serve(model, batch=2, prompt_len=prompt_len, tokens=3)
    eff = 448 if arch == "whisper-tiny" else prompt_len
    text = max(eff - cfg.vision_prefix, 1) if cfg.vision_prefix else eff
    cache_len = eff + cfg.vision_prefix + 3 + 1
    prefix = text + cfg.vision_prefix
    assert seen["prefill_cache_len"] == seen["decode_cache_len"] == cache_len
    assert seen["cache_slots"] == cache_len
    assert seen["positions"] == [[prefix + i] * 2 for i in range(3)]
    assert out.prompt.shape == (2, text) and out.prefix == prefix
    assert out.generated.shape == (2, 4)
    assert (seen["memory"] is None) == (arch != "whisper-tiny")
    assert out.prefill_tokens_per_s == 2 * prefix / out.prefill_s


def test_prefill_step_checks_patches(pair):
    """The prefill step refuses a VLM batch without its patches or with a
    prefix of another length."""
    _, _, model = pair
    step = make_prefill_step(model, batch=2, seq=24, cache_len=30)
    b = _port_batch(_batch(model.cfg, _rng(5), 2, 16))
    logits, _, _ = step(b)
    assert logits.shape == (2, model.cfg.vocab_size)
    for bad in ({"tokens": b["tokens"]},
                {"tokens": b["tokens"], "patches": b["patches"][:, :4]}):
        with pytest.raises(ValueError, match="inputs"):
            step(bad)


def test_launcher_refuses_the_front_ends(capsys):
    """ROADMAP Queue 3: the launcher feeds tokens only, as the
    reference's does, so ``train`` and the CLI refuse the audio and VLM
    archs; their serve CLI runs."""
    for arch in ("whisper-tiny", ARCH):
        model = make_model(get_config(arch).scaled_down(), device="cpu")
        with pytest.raises(ValueError, match="tokens only"):
            train_mod.train(model, steps=1, log=lambda s: None)
        with pytest.raises(ValueError, match="make_train_step"):
            train_mod.main(["--device", "cpu", "--arch", arch])
        serve_mod.main(["--device", "cpu", "--arch", arch, "--tokens", "2",
                        "--batch", "2"])
        assert f"[{arch}] prefill(2x" in capsys.readouterr().out
