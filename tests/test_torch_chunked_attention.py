"""The port's chunked (online-softmax) attention
(``repro_torch.models.layers._attend_chunked`` and the ``attn_impl="chunked"``
route of ``attention_apply``) on the CPU against the JAX reference's
``_attend_chunked`` in f32, on the same numpy-made q, k, v and masks, and
the reference's own check that the chunked loss equals the einsum loss.

Tolerances: the op within 1e-6 of the largest output magnitude (plus
1e-6 relative); whole attention blocks and models within the serve tests'
1e-4; the loss within the reference's rtol 1e-4
(``tests/test_arch_smoke.py::test_chunked_attention_matches_einsum``).
``pytest -s`` prints each gap as a share of the largest magnitude.
"""
import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, layers as L, loss_fn,
                                make_model, prefill)

OP_REL = 1e-6
REL = 1e-4


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


def _qkv(rng, B, S, T, H, KV, hd):
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    return q, k, v


def _mask(ref, pq, pk, window):
    return np.asarray(ref.layers._causal_mask(pq, pk, window))


# each case: (B, S, T, H, KV, hd, chunk, how the positions and window go)
CASES = {
    # T = 37 over chunks of 16: the last chunk is padded by 11 keys
    "ragged-last-chunk": (2, 37, 37, 4, 2, 16, 16, "causal"),
    # the default chunk of 512 is cut to T = 20
    "chunk-over-T": (2, 20, 20, 4, 1, 8, 512, "causal"),
    # a window of 5 over chunks of 8: a late row's early chunks are
    # masked whole, so the running max stays NEG_INF through them
    "window-masks-leading-chunks": (2, 40, 40, 4, 2, 16, 8, "window"),
    # a decode row against a ring buffer whose first 12 slots are empty
    # (pos -1) and fill the first two chunks of 6
    "ring-slots-unwritten": (3, 1, 30, 4, 4, 8, 6, "ring"),
    # G = 4 query heads a KV head, one query against 3 whole chunks
    "gqa4-decode": (2, 1, 24, 8, 2, 16, 8, "decode"),
}


def _case_inputs(ref, case):
    B, S, T, H, KV, hd, chunk, how = CASES[case]
    rng = _rng(11, len(case))
    q, k, v = _qkv(rng, B, S, T, H, KV, hd)
    if how in ("causal", "window"):
        pq = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        pk = pq
        window = 5 if how == "window" else None
    else:
        pk = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
        if how == "ring":
            pk[:, :12] = -1
        pq = np.full((B, 1), T - 1, np.int32)
        window = None
    return q, k, v, _mask(ref, pq, pk, window), chunk


@pytest.mark.parametrize("case", list(CASES))
def test_attend_chunked_matches_reference(ref, case):
    q, k, v, mask, chunk = _case_inputs(ref, case)
    want = ref.layers._attend_chunked(q, k, v, mask, chunk=chunk)
    got = L._attend_chunked(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                            chunk=chunk)
    _close(got, want, OP_REL)


@pytest.mark.parametrize("case", list(CASES))
def test_attend_chunked_equals_einsum(case, ref):
    """The two routes compute the same attention (the fully masked chunks
    included): within the op tolerance of each other."""
    q, k, v, mask, chunk = _case_inputs(ref, case)
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    _close(L._attend_chunked(*t, chunk=chunk),
           L._attend_einsum(*t).numpy(), OP_REL)


def test_fully_masked_leading_chunk_carries_exp0(ref):
    """Before a row's first unmasked key the reference's running max is
    NEG_INF and every masked key adds exp(0) = 1 to l; the first unmasked
    chunk's max rescales that to exactly 0. The port does the same: a
    row whose keys all lie in the last chunk reads only that chunk."""
    rng = _rng(12)
    q, k, v = _qkv(rng, 1, 1, 24, 2, 2, 8)
    mask = np.zeros((1, 1, 1, 24), bool)
    mask[..., 20:] = True
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = L._attend_chunked(*t, chunk=8)
    only = L._attend_einsum(t[0], t[1][:, 16:], t[2][:, 16:],
                            t[3][..., 16:])
    _close(got, ref.layers._attend_chunked(q, k, v, mask, chunk=8), OP_REL)
    _close(got, only.numpy(), OP_REL)


def _pair(ref, arch, seed=0):
    rcfg = ref.configs.get_config(arch).scaled_down()
    rmodel = ref.api.make_model(rcfg)
    params = ref.jax.tree.map(np.asarray,
                              rmodel.init(ref.jax.random.key(seed)))
    model = make_model(get_config(arch).scaled_down(), seed=None,
                       device="cpu")
    model.load_state_dict(interop.model_state(params))
    return rmodel, params, model


@pytest.fixture(scope="module")
def gemma(ref):
    """gemma3-4b scaled down: five local layers (window 64), one global."""
    return _pair(ref, "gemma3-4b")


@pytest.mark.parametrize("kind", ["global", "local"])
def test_attention_apply_chunked_prefill_and_decode(ref, gemma, kind):
    """One attention block of gemma3 (layer 5 global, layer 0 local) on
    the chunked route: a prefill of 2 x 600 tokens (two chunks of 512,
    the second ragged; the local rows' early chunk masked whole past the
    64-token window) into a 604-slot cache, then 3 decode steps, against
    the reference's chunked route."""
    _, params, model = gemma
    rcfg = ref.configs.get_config("gemma3-4b").scaled_down()
    jnp = ref.jax.numpy
    i = 5 if kind == "global" else 0
    p_r = ref.jax.tree.map(lambda a: jnp.asarray(a[0]),
                           params["groups"][f"b{i}"]["attn"])
    p_t = model.layers[i].attn
    assert model.cfg.kind(i) == kind
    rng = _rng(13, len(kind))
    B, S = 2, 600
    x = rng.normal(size=(B, S, model.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    fl = {"cache_len": S + 4, "attn_impl": "chunked"}
    y_r, c_r = ref.layers.attention_apply(
        rcfg, p_r, jnp.asarray(x), jnp.asarray(pos), kind=kind,
        mode="prefill", flags=fl)
    with torch.no_grad():
        y_p, c_p = L.attention_apply(
            model.cfg, p_t, torch.from_numpy(x),
            torch.from_numpy(pos.copy()), kind=kind, mode="prefill",
            flags=fl)
        _close(y_p, y_r)
        for step in range(3):
            xi = rng.normal(size=(B, 1, model.cfg.d_model)).astype(
                np.float32)
            pi = np.full((B, 1), S + step, np.int32)
            y_r, c_r = ref.layers.attention_apply(
                rcfg, p_r, jnp.asarray(xi), jnp.asarray(pi), kind=kind,
                cache=c_r, mode="decode", flags=fl)
            y_p, c_p = L.attention_apply(
                model.cfg, p_t, torch.from_numpy(xi),
                torch.from_numpy(pi).long(), kind=kind, cache=c_p,
                mode="decode", flags=fl)
            _close(y_p, y_r)
            _close(c_p["k"], c_r["k"])


def test_gemma3_prefill_and_decode_chunked_match_reference(ref, gemma):
    """The whole scaled-down gemma3 (5 local + 1 global layers) served on
    the chunked route, 2 x 80 prompt tokens (over the window) and 4 fed
    decode steps, against the reference's chunked route: logits within
    the serve tests' 1e-4."""
    rmodel, params, model = gemma
    jnp = ref.jax.numpy
    jparams = ref.jax.tree.map(jnp.asarray, params)
    fl = {"attn_impl": "chunked"}
    rng = _rng(14)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 80))
    feed = rng.integers(0, model.cfg.vocab_size, (2, 4))
    want, r_caches, _ = ref.api.prefill(
        rmodel, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, 85, fl)
    got, caches, _ = prefill(model, {"tokens": torch.from_numpy(tokens)},
                             85, fl)
    _close(got, want)
    for i in range(4):
        pos = np.full((2,), 80 + i, np.int32)
        want, r_caches = ref.api.decode_step(
            rmodel, jparams, jnp.asarray(feed[:, i:i + 1], jnp.int32),
            jnp.asarray(pos), r_caches, flags=fl)
        got, caches = decode_step(model, torch.from_numpy(feed[:, i:i + 1]),
                                  torch.from_numpy(pos).long(), caches,
                                  flags=fl)
        _close(got, want)


def test_llama_loss_chunked_matches_einsum(ref):
    """The reference's own check on the port: scaled-down llama3.2-1b,
    2 x 50 tokens, the chunked loss against the einsum loss within rtol
    1e-4, and each against the reference's on the same weights."""
    rmodel, params, model = _pair(ref, "llama3.2-1b")
    tokens = _rng(15).integers(0, model.cfg.vocab_size, (2, 50))
    jnp = ref.jax.numpy
    jparams = ref.jax.tree.map(jnp.asarray, params)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        l_e, _ = loss_fn(model, batch, flags={"attn_impl": "einsum"})
        l_c, _ = loss_fn(model, batch, flags={"attn_impl": "chunked"})
    np.testing.assert_allclose(float(l_e), float(l_c), rtol=1e-4)
    for impl, mine in (("einsum", l_e), ("chunked", l_c)):
        want, _ = ref.api.loss_fn(rmodel, jparams,
                                  {"tokens": jnp.asarray(tokens, jnp.int32)},
                                  flags={"attn_impl": impl})
        np.testing.assert_allclose(float(mine), float(want), rtol=1e-5)


def test_chunked_route_trains(ref):
    """Under autograd the chunked route keeps its scores (no in-place
    reuse): the gradients of a 2 x 40 llama3.2 loss equal the einsum
    route's within the serve tolerance, leaf by leaf."""
    _, _, model = _pair(ref, "llama3.2-1b")
    tokens = torch.from_numpy(_rng(16).integers(0, model.cfg.vocab_size,
                                                (2, 40)))
    grads = {}
    for impl in ("einsum", "chunked"):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, {"tokens": tokens},
                          flags={"attn_impl": impl})
        loss.backward()
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for name, g in grads["chunked"].items():
        _close(g, grads["einsum"][name].numpy())
