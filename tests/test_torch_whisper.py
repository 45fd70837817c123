"""The port's audio front end (``repro_torch.models``: the bidirectional
``"encoder"`` attention kind, cross-attention, ``Transformer.encode``, the
encoder-decoder's loss, prefill and decode, its leaves, checkpoints and
FL train step) on the CPU against the JAX reference at whisper-tiny's
``scaled_down()`` sizes in f32 (2 encoder and 2 decoder layers, d_model
128, 4 heads of 32, d_ff 256, vocab 512, 32 frame positions), with the
reference's weights carried across by ``repro_torch.interop.model_state``
and the same numpy-made inputs.

Tolerances: the attention blocks and ``encode`` within 1e-5 of the
reference's largest magnitude (plus 1e-5 relative); the loss, every
gradient leaf and the logits within 1e-4; the train step under the gates
of ``tests/test_torch_train_step.py`` (losses rtol 1e-5, parameters 1e-5
of the largest magnitude; digital: at most 0.1% of the entries beyond
1e-5 and none beyond 1e-2); checkpoints bit-equal. ``pytest -s`` prints
each gap as a share of the largest magnitude.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import rngstream
from repro_torch.launch.steps import fl_round_arrays, make_train_step
from repro_torch.models import (decode_step, layers as L, loss_fn,
                                make_model, param_count, prefill)
from repro_torch.optim import SGDConfig

ARCH = "whisper-tiny"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_REL = 1e-5
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
def pair(ref, ref4_started):
    """(reference model, its params as numpy, port model). The first test
    to ask for it also starts the 4-client reference run, which then
    compiles beside the other tests."""
    rmodel = ref.api.make_model(ref.configs.get_config(ARCH).scaled_down())
    params = ref.jax.tree.map(np.asarray, rmodel.init(ref.jax.random.key(0)))
    model = make_model(get_config(ARCH).scaled_down(), seed=None,
                       device="cpu")
    model.load_state_dict(interop.model_state(params))
    return rmodel, params, model


def _batch(cfg, rng, batch, seq):
    """numpy tokens (B, seq) and frames (B, encoder_positions, d)."""
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)),
            "frames": rng.standard_normal(
                (batch, cfg.encoder_positions, cfg.d_model)).astype(
                    np.float32)}


def _ref_batch(ref, b):
    jnp = ref.jax.numpy
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "frames": jnp.asarray(b["frames"])}


def _port_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]),
            "frames": torch.from_numpy(b["frames"])}


def _layer_params(ref, tree, g=0):
    return ref.jax.tree.map(lambda a: ref.jax.numpy.asarray(a[g]), tree)


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_encoder_attention_matches_reference(ref, pair, mode, impl):
    """The bidirectional kind on encoder layer 1 over 2 x 32 frames (and
    a prefill's cache of 40 slots): every key unmasked, rope applied."""
    rmodel, params, model = pair
    jnp = ref.jax.numpy
    cfg = model.cfg
    p_r = _layer_params(ref, params["enc_groups"]["b0"]["attn"], 1)
    x = _rng(1, len(mode)).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    fl = {"attn_impl": impl, "cache_len": 40}
    y_r, c_r = ref.layers.attention_apply(
        rmodel.cfg, p_r, jnp.asarray(x), jnp.asarray(pos), kind="encoder",
        mode=mode, flags=fl)
    with torch.no_grad():
        y_p, c_p = L.attention_apply(
            cfg, model.enc_layers[1].attn, torch.from_numpy(x),
            torch.from_numpy(pos.copy()), kind="encoder", mode=mode,
            flags=fl)
    _close(y_p, y_r, BLOCK_REL)
    if mode == "prefill":
        _close(c_p["k"], c_r["k"], BLOCK_REL)
        np.testing.assert_array_equal(c_p["pos"].numpy(),
                                      np.asarray(c_r["pos"]))
    else:
        assert c_p is None and c_r is None
    # bidirectional: the first query reads the last key
    with torch.no_grad():
        causal, _ = L.attention_apply(
            cfg, model.enc_layers[1].attn, torch.from_numpy(x),
            torch.from_numpy(pos.copy()), kind="global")
    assert float((causal[:, 0] - y_p[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attention_matches_reference(ref, pair, mode, impl):
    """Decoder layer 0's cross block: q from 2 x 5 queries (1 in decode),
    k and v from a 2 x 32 memory, no rope or mask; the cache it is given
    comes back unchanged, in every mode."""
    rmodel, params, model = pair
    jnp = ref.jax.numpy
    cfg = model.cfg
    p_r = _layer_params(ref, params["groups"]["b0"]["cross"])
    rng = _rng(2, len(mode), len(impl))
    S = 1 if mode == "decode" else 5
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.full((2, S), 7, np.int32)
    cache = {"k": torch.zeros(2, 9, cfg.n_kv_heads, cfg.hd)}
    fl = {"attn_impl": impl}
    y_r, c_r = ref.layers.attention_apply(
        rmodel.cfg, p_r, jnp.asarray(x), jnp.asarray(pos), mode=mode,
        cache=cache, flags=fl, cross_kv=jnp.asarray(mem))
    with torch.no_grad():
        y_p, c_p = L.attention_apply(
            cfg, model.layers[0].cross, torch.from_numpy(x),
            torch.from_numpy(pos), mode=mode, cache=cache, flags=fl,
            cross_kv=torch.from_numpy(mem))
    _close(y_p, y_r, BLOCK_REL)
    assert c_p is cache and c_r is cache


@pytest.mark.parametrize("impl", ROUTES)
def test_encode_matches_reference_and_keeps_einsum(ref, pair, monkeypatch,
                                                    impl):
    """``encode`` on 2 x 32 frames within 1e-5; the prefill's memory is
    ``encode``'s to the bit on either route: the encoder attends by
    einsum even when the caller asks for chunked, as the reference's
    (``flags=None`` there), whose memory equals its ``encode`` too."""
    rmodel, params, model = pair
    jnp = ref.jax.numpy
    b = _batch(model.cfg, _rng(3, len(impl)), 2, 6)
    jparams = ref.jax.tree.map(jnp.asarray, params)
    want = rmodel.encode(jparams, jnp.asarray(b["frames"]))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(b["frames"]))
    _close(got, want, BLOCK_REL)
    chunked_calls = []
    real = L._attend_chunked

    def spy(*a, **kw):
        chunked_calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(L, "_attend_chunked", spy)
    fl = {"attn_impl": impl}
    _, _, memory = prefill(model, _port_batch(b), 10, fl)
    assert torch.equal(memory, got)
    _, _, r_memory = ref.api.prefill(rmodel, jparams, _ref_batch(ref, b),
                                     10, fl)
    np.testing.assert_array_equal(np.asarray(r_memory), np.asarray(want))
    # chunked: only the decoder's self and cross blocks (keys of 6 and 32)
    n_dec = model.cfg.n_layers
    assert chunked_calls == ([] if impl == "einsum" else
                             [torch.Size([2, 6, 4, 32]),
                              torch.Size([2, 32, 4, 32])] * n_dec)


# ------------------------------------------------------------------- model

def test_loss_and_grads_match_reference(ref, pair):
    """``loss_fn`` on 2 x 24 tokens with 2 x 32 frames and the gradient of
    each of the 27 reference leaves (the encoder's ``enc_groups`` and
    ``enc_norm``, the decoder's ``cross`` and ``ln_cross`` included)
    within 1e-4; the leaves' paths and shapes are the reference's."""
    rmodel, params, model = pair
    jax = ref.jax
    b = _batch(model.cfg, _rng(4), 2, 24)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref.api.loss_fn(rmodel, p, _ref_batch(ref, b)),
        has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, _port_batch(b))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=REL)
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    leaves = interop.reference_leaves(model)
    assert len(leaves) == 27
    assert [lf.key for lf in leaves] == [
        "/".join(str(q.key) for q in path) for path, _ in flat]
    assert [lf.shape for lf in leaves] == [g.shape for _, g in flat]
    for leaf, (_, g) in zip(leaves, flat):
        _close(leaf.value(lambda p: p.grad), g)
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("impl", ROUTES)
def test_prefill_and_decode_match_reference(ref, pair, impl):
    """Prefill of 2 x 20 tokens (and 2 x 32 frames) into a 24-slot cache,
    then 3 decode steps fed the same tokens with the prefill's memory, on
    each attention route (the encoder on einsum in both packages):
    logits within 1e-4."""
    rmodel, params, model = pair
    jnp = ref.jax.numpy
    jparams = ref.jax.tree.map(jnp.asarray, params)
    fl = {"attn_impl": impl}
    rng = _rng(5, len(impl))
    b = _batch(model.cfg, rng, 2, 20)
    feed = rng.integers(0, model.cfg.vocab_size, (2, 3))
    want, r_caches, r_mem = ref.api.prefill(rmodel, jparams,
                                            _ref_batch(ref, b), 24, fl)
    got, caches, memory = prefill(model, _port_batch(b), 24, fl)
    assert memory.shape == (2, 32, model.cfg.d_model)
    _close(got, want)
    for i in range(3):
        pos = np.full((2,), 20 + i, np.int32)
        want, r_caches = ref.api.decode_step(
            rmodel, jparams, jnp.asarray(feed[:, i:i + 1], jnp.int32),
            jnp.asarray(pos), r_caches, memory=r_mem, flags=fl)
        got, caches = decode_step(
            model, torch.from_numpy(feed[:, i:i + 1]),
            torch.from_numpy(pos).long(), caches, memory=memory, flags=fl)
        _close(got, want)


def test_memory_none_raises_where_the_reference_self_attends(ref, pair):
    """ROADMAP Queue 3: a decode step of a cross model without the memory.
    The port raises; the reference runs its cross block as causal
    self-attention over its input (its layer equals the port's layer
    with that block called without ``cross_kv``), and its logits move
    away from the memory's."""
    rmodel, params, model = pair
    jnp = ref.jax.numpy
    cfg = model.cfg
    jparams = ref.jax.tree.map(jnp.asarray, params)
    b = _batch(cfg, _rng(6), 2, 12)
    with torch.no_grad():
        logits, caches, memory = prefill(model, _port_batch(b), 16)
        tok = torch.from_numpy(b["tokens"][:, -1:])
        pos = torch.full((2,), 12)
        with pytest.raises(ValueError, match="encoder memory"):
            decode_step(model, tok, pos, caches)
        with pytest.raises(ValueError, match="encoder memory"):
            model(model.embed[tok], pos[:, None], mode="train")
    _, r_caches, r_mem = ref.api.prefill(rmodel, jparams,
                                         _ref_batch(ref, b), 16)
    args = (rmodel, jparams, jnp.asarray(tok.numpy(), jnp.int32),
            jnp.asarray(pos.numpy(), jnp.int32), r_caches)
    with_mem, _ = ref.api.decode_step(*args, memory=r_mem)
    without, _ = ref.api.decode_step(*args, memory=None)
    gap = float(np.max(np.abs(np.asarray(with_mem) - np.asarray(without))))
    assert np.all(np.isfinite(np.asarray(without))) and gap > 1e-3
    print(f"reference logits without the memory move by {gap:.3g}")
    # the reference's layer 0 with memory=None is the port's layer with
    # its cross block as self-attention
    x = _rng(7).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    p6 = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    want, _, _ = ref.transformer._layer_apply(
        rmodel.cfg, "global", _layer_params(ref, params["groups"]["b0"]),
        jnp.asarray(x), jnp.asarray(p6), memory=None)
    layer = model.layers[0]
    with torch.no_grad():
        xt, pt = torch.from_numpy(x), torch.from_numpy(p6.copy())
        h = L.rms_norm(xt, layer.ln1, cfg.norm_eps)
        xt = xt + L.attention_apply(cfg, layer.attn, h, pt)[0]
        h = L.rms_norm(xt, layer.ln_cross, cfg.norm_eps)
        xt = xt + L.attention_apply(cfg, layer.cross, h, pt)[0]
        h = L.rms_norm(xt, layer.ln2, cfg.norm_eps)
        xt = xt + L.mlp_apply(cfg, layer.mlp, h)
    _close(xt, want, BLOCK_REL)


def test_parameter_count_and_leaves_at_full_size(ref):
    """61,074,432 bf16 parameters in 27 reference leaves, counted on the
    meta device against the reference's abstract params."""
    model = make_model(get_config(ARCH), seed=None, device="meta")
    abstract = ref.api.make_model(
        ref.configs.get_config(ARCH)).abstract_params()
    flat = ref.jax.tree_util.tree_flatten_with_path(abstract)[0]
    assert param_count(model) == 61_074_432 == ref.api.param_count(abstract)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    leaves = interop.reference_leaves(model)
    assert [(lf.key, lf.shape) for lf in leaves] == [
        ("/".join(str(q.key) for q in path), x.shape) for path, x in flat]
    assert len(model.enc_layers) == 4 and len(model.layers) == 4


def test_checkpoints_cross_packages(ref, pair, tmp_path):
    """The reference's whisper checkpoint loads into the port, and the
    port's into the reference, bit-equal (the encoder and cross leaves
    included)."""
    rmodel, params, model = pair
    jax = ref.jax
    ref.ckpt.save_checkpoint(tmp_path / "a", 3, params)
    mine = make_model(model.cfg, seed=None, device="cpu")
    restore_checkpoint(tmp_path / "a", latest_step(tmp_path / "a"), mine)
    assert all(torch.equal(mine.state_dict()[k], v)
               for k, v in model.state_dict().items())
    with torch.no_grad():
        mine.enc_layers[1].attn.wq.mul_(2.0)
        mine.layers[0].ln_cross.add_(1.0)
    save_checkpoint(tmp_path / "b", 4, mine)
    back = ref.ckpt.restore_checkpoint(tmp_path / "b", 4, params)
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    for leaf, (_, a) in zip(interop.reference_leaves(mine), flat):
        np.testing.assert_array_equal(np.asarray(a),
                                      leaf.value().detach().numpy())


# -------------------------------------------------------------- train step

AGGS = ("ideal", "ota", "digital")
STEPS, BATCH, SEQ, ETA = 3, 8, 16, 0.5

# The reference's train step on scaled-down whisper-tiny: 3 steps under
# each aggregator from the weights of key 0, each run's final parameters
# saved with the reference's own save_checkpoint, and the losses.
REF_SRC = textwrap.dedent('''
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import save_checkpoint
    from repro.configs import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import fl_round_arrays, make_train_step
    from repro.models import make_model
    from repro.optim.sgd import SGDConfig


    def run_all(inp, out_dir, arch, aggs, steps, batch, seq, eta):
        model = make_model(get_config(arch).scaled_down())
        params0 = model.init(jax.random.key(0))
        save_checkpoint(out_dir, 0, params0)
        mesh = make_host_mesh(model_axis=1, data_axis=len(jax.devices()))
        losses = {}
        for agg in aggs:
            sb = make_train_step(model, mesh, aggregator=agg,
                                 sgd=SGDConfig(eta=eta), batch=batch,
                                 seq=seq)
            f = jax.jit(sb.fn, in_shardings=sb.in_shardings,
                        out_shardings=sb.out_shardings)
            params, out = params0, []
            for t in range(steps):
                fl = fl_round_arrays(mesh, gammas=inp["gammas"],
                                     chis=inp["chis"][t], alpha=2.0,
                                     noise_scale=1e-3, levels=15.0)
                b = {"tokens": jnp.asarray(inp["tokens"][t]),
                     "frames": jnp.asarray(inp["frames"][t])}
                params, loss = f(params, b, fl, jax.random.key(t))
                out.append(float(loss))
            save_checkpoint(f"{out_dir}/{agg}", steps, params)
            losses[agg] = out
        return losses


    if __name__ == "__main__":
        import json, sys
        kw = json.loads(sys.argv[3])
        inp = dict(np.load(sys.argv[1]))
        print(json.dumps(run_all(inp, sys.argv[2], **kw)))
''')


def _train_inputs(n):
    cfg = get_config(ARCH).scaled_down()
    rng = _rng(n, 8)
    chis = np.ones((STEPS, n))
    chis[1, -1] = 0.0                 # a client out of a round (weight 0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (STEPS, BATCH, SEQ)
                                   ).astype(np.int32),
            "frames": rng.standard_normal(
                (STEPS, BATCH, cfg.encoder_positions, cfg.d_model)
            ).astype(np.float32),
            "gammas": np.linspace(0.5, 1.5, n), "chis": chis}


def _port_model(directory):
    model = make_model(get_config(ARCH).scaled_down(), seed=None,
                       device="cpu")
    return restore_checkpoint(directory, latest_step(directory), model)


def _check_train_run(inp, directory, agg, n, want_losses):
    """Three port steps from the reference's initial weights, against the
    reference's losses and final parameters."""
    model = _port_model(directory)
    step = make_train_step(model, n_clients=n, aggregator=agg,
                           sgd=SGDConfig(eta=ETA), batch=BATCH, seq=SEQ)
    losses = []
    for t in range(STEPS):
        fl = fl_round_arrays(n, gammas=inp["gammas"], chis=inp["chis"][t],
                             alpha=2.0, noise_scale=1e-3, levels=15.0)
        losses.append(float(step(
            {"tokens": torch.from_numpy(inp["tokens"][t]).long(),
             "frames": torch.from_numpy(inp["frames"][t])},
            fl, rngstream.prng_key(t))))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = _port_model(os.path.join(directory, agg))
    gaps, scale = [], 0.0
    for (k, a), b in zip(model.state_dict().items(),
                         want.state_dict().values()):
        gaps.append((a - b).abs().reshape(-1))
        scale = max(scale, float(b.abs().max()))
    gaps = torch.cat(gaps)
    over = float((gaps > 1e-5 * scale).float().mean())
    assert float(gaps.max()) <= (1e-2 if agg == "digital" else 1e-5) * scale
    assert over <= (1e-3 if agg == "digital" else 0.0)
    print(f"{agg}, {n} client(s): losses {losses}; parameter gap "
          f"{float(gaps.max()) / scale:.3g} of the largest magnitude, "
          f"{over:.2g} of entries above 1e-5")


@pytest.fixture(scope="module")
def ref1(ref, tmp_path_factory):
    """The reference's 3-step runs over one client, in this process."""
    d = tmp_path_factory.mktemp("whisper_ref1")
    ns = {}
    exec(REF_SRC, ns)
    inp = _train_inputs(1)
    losses = ns["run_all"](inp, str(d), ARCH, AGGS, STEPS, BATCH, SEQ, ETA)
    return inp, str(d), losses


@pytest.fixture(scope="module")
def ref4_started(tmp_path_factory):
    """The same over four clients on 4 JAX CPU devices, started in a
    subprocess (the device count is fixed when JAX starts): (inputs,
    directory, process)."""
    import json
    d = tmp_path_factory.mktemp("whisper_ref4")
    inp = _train_inputs(4)
    np.savez(d / "in.npz", **inp)
    (d / "ref4.py").write_text(REF_SRC)
    kw = dict(arch=ARCH, aggs=AGGS, steps=STEPS, batch=BATCH, seq=SEQ,
              eta=ETA)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, str(d / "ref4.py"),
                             str(d / "in.npz"), str(d), json.dumps(kw)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield inp, str(d), proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref4(ref4_started):
    """The 4-client reference run's (inputs, directory, losses)."""
    import json
    inp, d, proc = ref4_started
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return inp, d, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("agg", AGGS)
def test_train_step_one_client_matches_reference(ref1, agg):
    inp, d, losses = ref1
    _check_train_run(inp, d, agg, 1, losses[agg])


@pytest.mark.parametrize("agg", AGGS)
def test_train_step_four_clients_matches_reference(ref4, agg):
    """Each client's rows of tokens and frames, 27 leaves through the
    collective: the OTA noise and the dither land on the reference's
    entries only if the leaf order is the reference's."""
    inp, d, losses = ref4
    _check_train_run(inp, d, agg, 4, losses[agg])


def test_train_step_checks_frames(ref1):
    """The step refuses a batch without frames or with frames of another
    length."""
    inp, d, _ = ref1
    model = _port_model(d)
    step = make_train_step(model, n_clients=2, batch=BATCH, seq=SEQ)
    fl = fl_round_arrays(2)
    tokens = torch.from_numpy(inp["tokens"][0]).long()
    frames = torch.from_numpy(inp["frames"][0])
    for bad in ({"tokens": tokens}, {"tokens": tokens,
                                     "frames": frames[:, :16]}):
        with pytest.raises(ValueError, match="inputs"):
            step(bad, fl, rngstream.prng_key(0))
