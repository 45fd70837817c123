"""Layer-group rematerialisation (``Transformer.forward(remat=True)``, the
reference's ``jax.checkpoint`` of its scan body over layer groups) on the
CPU.

* The loss and every gradient leaf are bit-equal with ``remat=True`` and
  ``remat=False`` (the recompute repeats the forward's ops), for
  scaled-down tinyllama (also on the chunked attention route, whose
  branch on ``s.requires_grad`` must agree in both passes), gemma3-4b at
  8 layers (one group of 6 and 2 tail layers), recurrentgemma-2b at 4
  (one group of 3 and a tail layer), qwen3-moe-30b-a3b (the aux term and
  the router's gradients), whisper-tiny (the encoder's leaves, reached
  through the cross blocks) and falcon-mamba-7b.
* Structure, read from a spy on ``torch.utils.checkpoint.checkpoint``:
  one call a group over exactly the group's layers, none for the tail or
  the encoder, none in the prefill or decode modes or with
  ``remat=False``.
* The port under remat against the reference's ``loss_fn`` (remat on by
  default there) for gemma3-4b with a tail, within ``test_torch_dense``'s
  tolerance: rtol 1e-5 plus 1e-5 of the largest magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, loss_fn, make_batch,
                                make_model, prefill)

pytestmark = pytest.mark.usefixtures("one_thread")

REL = 1e-5
# (arch, layers: None keeps scaled_down()'s, flags)
CASES = {
    "tinyllama": ("tinyllama-1.1b", None, None),
    "tinyllama-chunked": ("tinyllama-1.1b", None, {"attn_impl": "chunked"}),
    "gemma3-tail": ("gemma3-4b", 8, None),
    "recurrentgemma-tail": ("recurrentgemma-2b", 4, None),
    "qwen3-moe": ("qwen3-moe-30b-a3b", None, None),
    "whisper": ("whisper-tiny", None, None),
    "falcon-mamba": ("falcon-mamba-7b", None, None),
}


def _cfg(arch, n_layers=None):
    cfg = get_config(arch).scaled_down()
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _model_and_batch(name):
    arch, n_layers, flags = CASES[name]
    cfg = _cfg(arch, n_layers)
    model = make_model(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, 2, 16, torch.Generator().manual_seed(3))
    return model, batch, flags


def _loss_and_grads(model, batch, flags, remat):
    """(loss, metrics, every parameter's gradient by name) of one
    ``loss_fn`` with ``forward``'s ``remat`` set."""
    forward = model.forward
    model.forward = lambda *a, **kw: forward(*a, remat=remat, **kw)
    try:
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch, flags)
        loss.backward()
    finally:
        del model.forward
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: p.grad.clone() for n, p in model.named_parameters()}


class Spy:
    """Records the layer span [start, stop) of each checkpointed call."""

    def __init__(self, monkeypatch):
        self.spans = []
        real = torch.utils.checkpoint.checkpoint

        def spy(fn, *args, **kw):
            self.spans.append(tuple(args[3:5]))
            assert kw.get("use_reentrant") is False
            return real(fn, *args, **kw)
        monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)


@pytest.mark.parametrize("name", list(CASES))
def test_remat_loss_and_grads_bit_equal(name):
    model, batch, flags = _model_and_batch(name)
    loss0, met0, grads0 = _loss_and_grads(model, batch, flags, remat=False)
    loss1, met1, grads1 = _loss_and_grads(model, batch, flags, remat=True)
    assert torch.isfinite(loss0) and torch.equal(loss1, loss0)
    assert all(torch.equal(met1[k], met0[k]) for k in met0)
    if model.cfg.n_experts:
        assert float(met0["aux"]) > 0
    assert list(grads1) == list(grads0)
    differ = [n for n in grads0 if not torch.equal(grads1[n], grads0[n])]
    assert not differ, differ
    # every parameter reached: the encoder's through the cross blocks,
    # the routers through the aux term
    assert all(bool(g.abs().sum() > 0) for n, g in grads0.items()
               if n.startswith(("enc_layers", "layers.0.moe.router"))), name


@pytest.mark.parametrize("name", ["tinyllama", "gemma3-tail",
                                  "recurrentgemma-tail", "whisper"])
def test_remat_checkpoints_the_groups(monkeypatch, name):
    """``n_groups`` calls, each over one pass of the pattern; the tail
    layers and the encoder run outside them."""
    model, batch, flags = _model_and_batch(name)
    cfg = model.cfg
    size = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // size
    spy = Spy(monkeypatch)
    loss, _ = loss_fn(model, batch, flags)
    assert spy.spans == [(g * size, (g + 1) * size)
                         for g in range(n_groups)]
    assert cfg.n_layers - n_groups * size == {
        "gemma3-tail": 2, "recurrentgemma-tail": 1}.get(name, 0)
    spy.spans.clear()
    loss.backward()                  # the recompute calls no checkpoint
    assert spy.spans == []
    with torch.no_grad():
        x = torch.zeros((1, 3, cfg.d_model))
        model(x, torch.zeros((1, 3), dtype=torch.int32), remat=False,
              memory=x if cfg.encoder_layers else None)
    assert spy.spans == []


@pytest.mark.parametrize("name", ["gemma3-tail", "whisper"])
def test_remat_ignored_when_serving(monkeypatch, name):
    model, batch, _ = _model_and_batch(name)
    spy = Spy(monkeypatch)
    logits, caches, memory = prefill(model, batch, cache_len=20)
    token = logits.argmax(-1)[:, None]
    decode_step(model, token, torch.full((2,), 16), caches, memory)
    assert spy.spans == []


def test_remat_matches_reference_with_a_tail(ref):
    """gemma3-4b at 8 layers (1 group of 6, 2 tail layers): the port's
    ``loss_fn`` (remat on by default) against the reference's (remat on
    by default), loss and every gradient leaf."""
    jax = ref.jax
    rcfg = dataclasses.replace(
        ref.configs.get_config("gemma3-4b").scaled_down(), n_layers=8)
    rmodel = ref.api.make_model(rcfg)
    assert (rmodel.n_groups, rmodel.n_tail) == (1, 2)
    model = make_model(_cfg("gemma3-4b", 8), seed=0, device="cpu")
    params = {}              # the port's weights as the reference's tree
    for leaf in interop.reference_leaves(model):
        *path, name = leaf.key.split("/")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[name] = leaf.value().detach().numpy()
    toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (2, 16)).astype(np.int32)
    want, grads = jax.jit(jax.value_and_grad(lambda p: ref.api.loss_fn(
        rmodel, p, {"tokens": toks})[0]))(params)
    loss, _ = loss_fn(model, {"tokens": torch.from_numpy(toks).long()})
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    leaves = interop.reference_leaves(model)
    assert [lf.key for lf in leaves] == [
        "/".join(str(q.key) for q in path) for path, _ in flat]
    for got, want_ in [(loss, want)] + [
            (leaf.value(lambda p: p.grad), g)
            for leaf, (_, g) in zip(leaves, flat)]:
        got = got.detach().numpy()
        want_ = np.asarray(want_)
        scale = float(np.max(np.abs(want_)))
        np.testing.assert_allclose(got, want_, rtol=REL, atol=REL * scale)
