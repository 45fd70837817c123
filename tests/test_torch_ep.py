"""The port's expert-parallel MoE (``models.layers._moe_apply_ep``,
``_a2a_quantized``, ``core.dist.all_to_all``), the mesh train step under
``moe_impl="ep"`` (``skip_psum`` on the expert leaves) and the serve
steps on a data mesh, against the reference's on two XLA CPU devices.

One module-scoped subprocess runs ``_torch_ep_ref.py`` (the reference on
a (data=2, model=1) mesh, qwen3-moe-30b-a3b ``scaled_down()`` in f32, the
weights of ``jax.random.key(0)``) and saves its outputs; one 2-rank gloo
group runs ``_torch_ranks.ep_job`` from the same weights, each rank
loading only its blocks (``interop.model_state``'s mesh form). Inputs are
numpy-made from a seed: a (4, 96, 128) block input and prompts of 80
tokens and train batches of 4 x 80 (160 tokens a rank: the capacity
path, C = 100), 4 fed decode steps, client weights 0.7 and 1.3.

Tolerances:
  * ``moe_apply`` EP: y within 1e-5 of the largest magnitude, aux within
    1e-6 relative (the mean of the ranks' terms, the reference's
    ``pmean``); with ``moe_a2a_quant`` the same except where a code of
    the return exchange flipped (the two packages' expert outputs differ
    in the last bits, and an entry within that of a rounding boundary
    takes the other code): at most 1e-3 of the entries, within 2e-2;
  * the int8 exchange on a fed buffer: codes, scales and output bit-equal;
  * prefill and decode logits within 1e-4 of the largest magnitude;
  * the weighted clients' summed gradients, leaf by leaf, the router's
    on its own, within 1e-5 of the leaf's largest magnitude;
  * train steps, two a case: losses within 1e-5 relative, parameters
    within 1e-5 of the largest magnitude (ideal, OTA); digital as
    ``test_torch_train_step.py``'s (1e-2, at most 1e-3 of the entries
    over 1e-5: dither codes flip); each aggregator with
    ``moe_a2a_quant`` within 1e-2 and its losses within 2e-4 relative:
    its code flips move whole tokens (the first step's loss 3.6e-6 from
    the reference's, the second's, after an update from gradients 10% of
    whose entries moved, up to 6.4e-5), so no share bound either; digital
    with it within 5e-2 (those moved gradients flip 15-level dither codes,
    each moving an entry by eta 2m/14: 3.4e-2 of the largest read);
  * every rank's replicated leaves the same, bit for bit.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_reference import one_thread  # noqa: F401  (module fixture)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import rngstream
from repro_torch.launch import analysis, distributed, sharding
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import (fl_round_arrays, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      sharded_leaves)
from repro_torch.models import layers as L
from repro_torch.models import make_model

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERT_LEAVES = ("groups/b0/moe/w_down", "groups/b0/moe/w_gate",
                 "groups/b0/moe/w_up")


def _inputs():
    rng = np.random.default_rng([30, 1])
    u = (rng.standard_normal((4, 2, 5, 128))
         * rng.uniform(0.01, 50.0, (4, 1, 1, 1))).astype(np.float32)
    u[1] = 0.0                     # a source of zeros: scale 0, codes 0
    return dict(x=rng.standard_normal((4, 96, 128)).astype(np.float32),
                u=u, prompt=rng.integers(0, 512, (4, 80)).astype(np.int32),
                feed=rng.integers(0, 512, (4, 4)).astype(np.int32),
                tokens=rng.integers(0, 512, (2, 4, 80)).astype(np.int32),
                gammas=np.array([0.7, 1.3]), eta=np.float64(0.5))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, each rank's results)."""
    d = tmp_path_factory.mktemp("ep")
    np.savez(d / "in.npz", **_inputs())
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "tests", "_torch_ep_ref.py"),
                          str(d / "in.npz"), str(d / "ref.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ranks = distributed.spawn(
        R.run_jobs, 2, device="cpu", store_dir=d,
        args=([("ep", "ep_job", (str(d / "in.npz"), str(d / "ref.npz")))],))
    return (dict(np.load(d / "in.npz")), dict(np.load(d / "ref.npz")),
            [r["ep"] for r in ranks])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


def _gap(got, want):
    """The largest gap over the largest |want|."""
    got, want = np.asarray(_np(got), np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rows(a, rank):
    b = a.shape[0] // 2
    return a[rank * b:(rank + 1) * b]


def _block(want, key, rank):
    """Rank ``rank``'s block of a reference leaf: the experts' axis cut
    in two for the expert leaves, the whole leaf for the others."""
    if key not in EXPERT_LEAVES:
        return want
    return sharding.local_block(want, sharding.Spec(None, "data"),
                                abstract_mesh(2, client=rank))


@pytest.mark.parametrize("quant", [False, True])
def test_moe_apply_ep_matches_reference(runs, quant):
    inp, ref, ranks = runs
    tag = "ep_quant" if quant else "ep"
    want_y = ref[f"moe/{tag}_y"]
    scale = float(np.abs(want_y).max())
    for rank, out in enumerate(ranks):
        y, aux = out[f"moe/{tag}"]
        want = _rows(want_y, rank)
        gap = np.abs(_np(y).astype(np.float64) - want)
        if quant:
            assert float((gap > 1e-5 * scale).mean()) <= 1e-3
            assert float(gap.max()) <= 2e-2 * scale
        else:
            assert float(gap.max()) <= 1e-5 * scale
        np.testing.assert_allclose(float(aux), float(ref[f"moe/{tag}_aux"]),
                                   rtol=1e-6)
        print(f"{tag} rank {rank}: y gap {float(gap.max()) / scale:.3g}")
    # the reference's own EP y is its auto route's; its aux is the
    # ranks' mean, not the global batch's
    np.testing.assert_array_equal(ref["moe/ep_y"], ref["moe/auto_y"])
    assert float(ref["moe/ep_aux"]) != float(ref["moe/auto_aux"])


def test_int8_exchange_bit_equal_on_a_fed_buffer(runs):
    """Codes and scales of each rank's (2, 2, 5, 128) buffer bit-equal to
    the reference's lines written in jnp, the exchanged and dequantised
    output bit-equal to the reference's ``_a2a_quantized``."""
    import jax.numpy as jnp
    inp, ref, ranks = runs
    for rank, out in enumerate(ranks):
        u = jnp.asarray(_rows(inp["u"], rank))
        scale = jnp.max(jnp.abs(u), axis=(1, 2, 3),
                        keepdims=True).astype(jnp.float32)
        q = jnp.clip(jnp.round(u / jnp.maximum(scale, 1e-30) * 127.0),
                     -127, 127).astype(jnp.int8)
        codes, scales = out["a2a/codes"]
        np.testing.assert_array_equal(codes.numpy(), np.asarray(q))
        np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                      np.asarray(scale).view(np.uint32))
        np.testing.assert_array_equal(
            out["a2a/out"].numpy().view(np.uint32),
            _rows(ref["a2a/out"], rank).view(np.uint32))
    assert not ranks[0]["a2a/codes"][0][1].any()       # the zero source


def test_prefill_and_decode_on_the_mesh_match_reference(runs):
    _, ref, ranks = runs
    for rank, out in enumerate(ranks):
        prefill, decode = out["serve"]
        assert _gap(prefill, _rows(ref["serve/prefill"], rank)) <= 1e-4
        assert _gap(decode, ref["serve/decode"][:, 2 * rank:2 * rank + 2]
                    ) <= 1e-4


def test_skip_psum_on_exactly_the_expert_leaves(runs):
    _, ref, ranks = runs
    keys = list(ranks[0]["grad"])
    for out in ranks:
        assert out["skip"] == [bool(s) for s in ref["skip"]]
        assert [k for k, s in zip(keys, out["skip"]) if s] == list(
            EXPERT_LEAVES)


@pytest.mark.parametrize("which", ["router", "others"])
def test_summed_gradients_match_reference(runs, which):
    """The clients' weighted gradients, summed as the train step sums
    them: the router's (where the aux term's pmean shows: a factor of n
    there would be 100x this bound) and every other leaf's."""
    _, ref, ranks = runs
    for rank, out in enumerate(ranks):
        for key, g in out["grad"].items():
            if (key == "groups/b0/moe/router") != (which == "router"):
                continue
            gap = _gap(g, _block(ref["grad/" + key], key, rank))
            assert gap <= 1e-5, (key, gap)


@pytest.mark.parametrize("tag", [t for t, _, _ in R.EP_TRAIN])
def test_train_step_matches_reference(runs, tag):
    _, ref, ranks = runs
    want_losses = ref[f"train/{tag}/losses"]
    scale = max(float(np.abs(ref[f"train/{tag}/{k}"]).max())
                for k in ranks[0][f"train/{tag}"][1])
    for rank, out in enumerate(ranks):
        losses, leaves = out[f"train/{tag}"]
        np.testing.assert_allclose(
            losses, want_losses, rtol=2e-4 if tag.endswith("_quant") else 1e-5)
        gaps = np.concatenate([
            np.abs(_np(v).astype(np.float64)
                   - _block(ref[f"train/{tag}/{k}"], k, rank)).reshape(-1)
            for k, v in leaves.items()])
        over = float((gaps > 1e-5 * scale).mean())
        if tag == "digital":
            assert gaps.max() <= 1e-2 * scale and over <= 1e-3
        elif tag == "digital_quant":
            assert gaps.max() <= 5e-2 * scale
        elif tag.endswith("_quant"):
            assert gaps.max() <= 1e-2 * scale
        else:
            assert gaps.max() <= 1e-5 * scale
        print(f"{tag} rank {rank}: gap {gaps.max() / scale:.3g} of the "
              f"largest, {over:.3g} of entries over 1e-5")
    for k, v in ranks[0][f"train/{tag}"][1].items():
        if k not in EXPERT_LEAVES:
            assert torch.equal(v, ranks[1][f"train/{tag}"][1][k]), k


# ------------------------------------------- routes without a process group

def _small(**kw):
    return dataclasses.replace(get_config(R.EP_ARCH).scaled_down(), **kw)


def test_ep_falls_through_when_the_experts_do_not_split():
    """E = 3 on a 2-rank data axis: the rules keep the experts whole, so
    ``moe_impl="ep"`` under the mesh runs the auto route (the same bits),
    as the reference's falls through."""
    cfg = _small(n_experts=3)
    mesh = abstract_mesh(2)
    model = make_model(cfg, seed=0, device="cpu",
                       placement=sharding.Placement(mesh))
    moe = model.layers[0].moe
    assert moe.w_gate.shape[0] == 3
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 40, 128)).astype(np.float32))
    with torch.no_grad():
        auto = L.moe_apply(cfg, moe, x)
        ep = L.moe_apply(cfg, moe, x, {"moe_impl": "ep", "mesh": mesh})
    assert torch.equal(auto[0], ep[0]) and torch.equal(auto[1], ep[1])


def test_serve_steps_refuse_a_batch_that_does_not_split():
    model = make_model(_small(), seed=0, device="cpu",
                       placement=sharding.Placement(abstract_mesh(2)))
    for make in (lambda: make_prefill_step(model, batch=3, seq=8,
                                           mesh=abstract_mesh(2)),
                 lambda: make_decode_step(model, batch=1, cache_len=8,
                                          mesh=abstract_mesh(2))):
        with pytest.raises(NotImplementedError,
                           match="part B: sequence-sharded caches"):
            make()


def test_model_on_a_placement_is_the_one_card_models_block():
    """A rank's model from a seed: each parameter the one-card model's
    block, bit for bit (the expert leaves cut on their experts' axis,
    the others whole), and the same leaf axes and whole shapes."""
    cfg = _small(n_layers=3)
    whole = make_model(cfg, seed=7, device="cpu")
    for rank in range(2):
        mesh = abstract_mesh(2, client=rank)
        part = make_model(cfg, seed=7, device="cpu",
                          placement=sharding.Placement(mesh))
        assert part.axes() == whole.axes()
        assert part.full_shapes() == whole.full_shapes()
        for (name, a), b in zip(part.named_parameters(), whole.parameters()):
            if name.split(".")[-1] in ("w_gate", "w_up", "w_down"):
                b = b[rank * 2:(rank + 1) * 2]
            assert torch.equal(a, b), name
        specs = [sharding.restrict(s, ("data",))
                 for s in sharding.params_specs(mesh, part)]
        assert [leaf.key for leaf, s in zip(interop.reference_leaves(part),
                                            specs) if s] == list(
            EXPERT_LEAVES)
        assert sharded_leaves(part, mesh, {"moe_impl": "ep"}) == [
            bool(s) for s in specs]
        with pytest.raises(ValueError, match="Placement"):
            sharded_leaves(part, mesh, {})


def test_serve_steps_drop_the_aux_mean():
    """A prefill and a decode step of one rank on the meta device over 4
    ranks: each MoE layer exchanges its buffer twice and nothing else, as
    serving drops aux (no all-reduce of the ranks' aux terms)."""
    world, batch, seq = 4, 8, 16
    cfg = _small(n_experts=8)
    mesh = abstract_mesh(world, client=1)
    model = make_model(cfg, seed=None, device="meta",
                       placement=sharding.Placement(mesh))
    rows = batch // world
    pre = make_prefill_step(model, batch=batch, seq=seq,
                            cache_len=seq + 2, mesh=mesh)
    dec = make_decode_step(model, batch=batch, cache_len=seq + 2, mesh=mesh)
    tokens = torch.empty(batch, seq, dtype=torch.int64, device="meta")
    (_, caches, memory), counter, _ = analysis.reckon(
        lambda: pre({"tokens": tokens}), list(model.parameters()))
    assert counter.collective_calls == {"all_to_all": 2 * cfg.n_layers}
    _, counter, _ = analysis.reckon(
        lambda: dec(torch.empty(rows, 1, dtype=torch.int64, device="meta"),
                    torch.full((rows,), seq, dtype=torch.int64,
                               device="meta"), caches, memory),
        list(model.parameters()))
    assert counter.collective_calls == {"all_to_all": 2 * cfg.n_layers}


def test_all_to_all_reckoned_on_an_abstract_mesh():
    """One rank's EP train step on the meta device over 4 ranks: each MoE
    layer exchanges twice forward, twice in the remat's recompute and
    twice backward, each sending (W-1)/W of its (W, E/W, C, d) buffer;
    the aux mean is one all-reduce forward and one backward (the
    recompute stops once the tensors the backward pass needs are made
    again, before it); the all-reduces of the leaves skip the 3 expert
    leaves."""
    world, batch, seq = 4, 8, 64
    cfg = _small(n_experts=8)
    mesh = abstract_mesh(world, client=1)
    model = make_model(cfg, seed=None, device="meta",
                       placement=sharding.Placement(mesh))
    step = make_train_step(model, mesh=mesh, aggregator="ota", batch=batch,
                           seq=seq, flags={"moe_impl": "ep"})
    tokens = torch.empty(batch, seq, dtype=torch.int64, device="meta")
    _, counter, _ = analysis.reckon(
        lambda: step({"tokens": tokens}, fl_round_arrays(mesh),
                     rngstream.prng_key(0)), list(model.parameters()))
    n_layers, n_leaves = cfg.n_layers, len(interop.reference_leaves(model))
    assert counter.collective_calls == {
        "all_to_all": 6 * n_layers,
        "all_reduce": 2 * n_layers + n_leaves - 3 + 1}
    T = batch // world * seq
    C = L._capacity(cfg, T)
    buf = cfg.n_experts * C * cfg.d_model * 4
    assert counter.collective_bytes["all_to_all"] == (
        6 * n_layers * (world - 1) * buf // world)
    assert counter.kernel_calls["ota_combine_keyed"] == n_leaves
    assert math.isclose(analysis.time_terms(counter)["collective_s"],
                        analysis.collective_stats(counter)["total_bytes"]
                        / analysis.H100.link_bytes_per_s)
