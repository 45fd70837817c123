"""The port's client and trial axes across ranks (``launch/distributed.py``,
``launch/mesh.py``, ``core/dist.py``, the mesh forms of
``core.collectives.wireless_psum`` and ``launch.steps.make_train_step``,
``FLEngine(shard_trials=True)``),
with real ranks on the CPU: ``distributed.spawn`` under ``gloo``, a
``FileStore`` under the test's temporary directory. One 2-rank and one
4-rank group run every rank check of this module (``_torch_ranks``); the
results are compared here with the one-card forms on the same inputs.

Tolerances:
  * 2 ranks: bit-equal to the one-card forms (a sum of two terms is the
    same in either order): the collective in each mode, the train step's
    losses and parameters under each aggregator, the sharded engine runs;
  * 4 ranks: the collective's sums within ``SUM_ULPS`` ulp of the sum of
    the terms' magnitudes (gloo need not add in client order), plus 1 ulp
    of the result; each client's digital payload bit-equal, on a (4, 1)
    and a (2, 2, 1) pod mesh; the sharded engine runs bit-equal (each
    trial's stream is keyed by its global index, and its gradient is
    computed in the unsharded run's layout of the trials);
  * every rank returns the same parameters and the same run, bit for bit.
"""
import math

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_reference import one_thread  # noqa: F401  (module fixture)
from repro_torch.core import dist as core_dist, rngstream
from repro_torch.core.collectives import wireless_psum
from repro_torch.launch import distributed, mesh as mesh_lib
from repro_torch.launch.steps import fl_round_arrays, make_train_step
from repro_torch.optim import SGDConfig

pytestmark = pytest.mark.usefixtures("one_thread")

SUM_ULPS = 2.0
CFG = dict(name="fl-small", arch_type="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=128, head_dim=16)
AGGS = ("ideal", "ota", "digital")
STEPS, BATCH, SEQ, ETA = 3, 8, 16, 0.5


def _fl_inputs(n):
    rng = np.random.default_rng([n, 7])
    chis = np.ones((STEPS, n))
    chis[1, -1] = 0.0                 # a client out of a round (weight 0)
    return {"tokens": rng.integers(0, CFG["vocab_size"], (STEPS, BATCH, SEQ)
                                   ).astype(np.int32),
            "gammas": np.linspace(0.5, 1.5, n), "chis": chis}


def _spawn(world, jobs, tmp_path_factory):
    return distributed.spawn(R.run_jobs, world, device="cpu",
                             store_dir=tmp_path_factory.mktemp("ranks"),
                             args=(jobs,))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """Two ranks: the collective, three train steps a aggregator from
    seeded weights, the sharded engine runs."""
    jobs = [("psum", "psum_job", (R.psum_inputs(2),)),
            ("train", "train_job", (("seeded_model", CFG, 3), _fl_inputs(2),
                                    AGGS, STEPS, BATCH, SEQ, ETA)),
            ("shard", "shard_job", ()),
            ("launcher", "launcher_job", (CFG, 5, 2, BATCH, SEQ))]
    return _spawn(2, jobs, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """Four ranks: the collective on a (4, 1) and a (2, 2, 1) pod mesh, the
    sharded engine runs."""
    inp = R.psum_inputs(4)
    jobs = [("psum", "psum_job", (inp,)),
            ("pod", "psum_job", (inp, True, 2)),
            ("shard", "shard_job", ())]
    return _spawn(4, jobs, tmp_path_factory)


@pytest.fixture(scope="module")
def unsharded():
    return R.engine_runs(False)


def _one_card(inp, mode, weight=None):
    names = sorted(R.LEAVES)
    clients = [[torch.from_numpy(inp["g/" + k][m]) for k in names]
               for m in range(int(inp["n"]))]
    key = rngstream.prng_key(int(inp["seed"]))
    return [g.numpy() for g in wireless_psum(
        iter(clients), R.psum_round(inp, weight), key, mode=mode)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _assert_same_on_every_rank(results, name):
    first = results[0][name]
    for r in results[1:]:
        for mode in ("ideal", "ota", "digital"):
            for a, b in zip(first[mode], r[name][mode]):
                np.testing.assert_array_equal(_bits(a), _bits(b))


def _own_payloads_bit_equal(inp, results, name):
    """Each client's digital payload w_c Q(g_c) (skip_psum) is the one-card
    form's client c alone, bit for bit."""
    for r in results:
        out = r[name]
        c = out["client"]
        alone = np.zeros_like(inp["weight"])
        alone[c] = inp["weight"][c]
        want = _one_card(inp, "digital", alone)
        for a, b in zip(out["own"], want):
            np.testing.assert_array_equal(_bits(a + 0.0), _bits(b + 0.0))


# ------------------------------------------------------------ collective

def test_psum_two_ranks_bit_equal(ranks2):
    inp = R.psum_inputs(2)
    assert [r["psum"]["client"] for r in ranks2] == [0, 1]
    _assert_same_on_every_rank(ranks2, "psum")
    for mode in ("ideal", "ota", "digital"):
        for a, b in zip(ranks2[0]["psum"][mode], _one_card(inp, mode)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(_bits(a), _bits(b))
    _own_payloads_bit_equal(inp, ranks2, "psum")


@pytest.mark.parametrize("name", ["psum", "pod"])
def test_psum_four_ranks_within_sum_ulps(ranks4, name):
    """The sums within SUM_ULPS ulp of the terms' magnitudes (+ 1 ulp of
    the result); the pod mesh's client index is pod * |data| + data."""
    inp = R.psum_inputs(4)
    shapes = {"psum": {"data": 4, "model": 1},
              "pod": {"pod": 2, "data": 2, "model": 1}}
    assert [r[name]["client"] for r in ranks4] == [0, 1, 2, 3]
    assert all(r[name]["shape"] == shapes[name] for r in ranks4)
    _assert_same_on_every_rank(ranks4, name)
    w = np.abs(inp["weight"].astype(np.float64))
    worst = {}
    for mode in ("ideal", "ota", "digital"):
        want = _one_card(inp, mode)
        for j, k in enumerate(sorted(R.LEAVES)):
            g = np.abs(inp["g/" + k].astype(np.float64))
            if mode == "ideal":
                scale = g.sum(0) / 4
            elif mode == "ota":
                scale = np.tensordot(w, g, axes=1) / float(inp["alpha"])
            else:
                scale = np.abs(np.stack([r[name]["own"][j] for r in ranks4]
                                        ).astype(np.float64)).sum(0)
            got = ranks4[0][name][mode][j].astype(np.float64)
            tol = (SUM_ULPS * np.spacing(scale.astype(np.float32))
                   + np.spacing(np.abs(want[j])))
            gap = np.abs(got - want[j])
            assert np.all(gap <= tol), (mode, k, float(np.max(gap / tol)))
            worst[mode] = max(worst.get(mode, 0.0),
                              float(np.max(gap / tol)))
    _own_payloads_bit_equal(inp, ranks4, name)
    print(f"{name}: worst gap as a share of its tolerance {worst}")


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("agg", AGGS)
def test_train_step_two_ranks_bit_equal(ranks2, agg):
    """Three mesh steps on two ranks: the one-card 2-client step's losses
    and parameters, bit for bit, the same on both ranks."""
    fl_in = _fl_inputs(2)
    model = R.seeded_model(CFG, 3)
    step = make_train_step(model, n_clients=2, aggregator=agg,
                           sgd=SGDConfig(eta=ETA), batch=BATCH, seq=SEQ)
    losses = []
    for t in range(STEPS):
        fl = fl_round_arrays(2, gammas=fl_in["gammas"], chis=fl_in["chis"][t],
                             alpha=2.0, noise_scale=1e-3, levels=15.0)
        losses.append(float(step(
            {"tokens": torch.from_numpy(fl_in["tokens"][t]).long()}, fl,
            rngstream.prng_key(t))))
    want = model.state_dict()
    for r in ranks2:
        got_losses, state = r["train"][agg]
        assert got_losses == losses
        assert all(torch.equal(state[k], want[k]) for k in want)


def test_launcher_with_a_client_a_rank(ranks2):
    """The launcher's ``train`` on a 2-rank mesh: the one-card launcher's
    losses and parameters over 2 clients, bit for bit."""
    from repro_torch.launch.train import train
    model = R.seeded_model(CFG, 5)
    log = train(model, n_clients=2, steps=2, batch=BATCH, seq=SEQ,
                log=lambda s: None)
    want = model.state_dict()
    for r in ranks2:
        losses, state = r["launcher"]
        assert losses == log.losses
        assert all(torch.equal(state[k], want[k]) for k in want)


def test_collective_reckoned_on_an_abstract_mesh():
    """One rank's mesh step on the meta device: one all-reduce a reference
    leaf and one for the loss, each charged 2(W-1)/W of its f32 bytes,
    and their time over the link rate in the collective term."""
    from repro_torch import interop
    from repro_torch.launch import analysis
    from repro_torch.models import make_model
    from repro_torch.models.common import ModelConfig
    model = make_model(ModelConfig(**CFG, dtype=torch.float32), seed=None,
                       device="meta")
    world = 4
    mesh = mesh_lib.abstract_mesh(world, client=1)
    step = make_train_step(model, mesh=mesh, aggregator="ota", batch=BATCH,
                           seq=SEQ)
    tokens = torch.empty(BATCH, SEQ, dtype=torch.int64, device="meta")
    _, counter, _ = analysis.reckon(
        lambda: step({"tokens": tokens}, fl_round_arrays(mesh),
                     rngstream.prng_key(0)), list(model.parameters()))
    leaves = interop.reference_leaves(model)
    assert counter.collective_calls == {"all_reduce": len(leaves) + 1}
    assert counter.kernel_calls["ota_combine_keyed"] == len(leaves)
    f32_bytes = [4 * math.prod(leaf.shape) for leaf in leaves] + [4]
    stats = analysis.collective_stats(counter)
    assert stats["total_bytes"] == sum(2 * (world - 1) * b // world
                                       for b in f32_bytes)
    terms = analysis.time_terms(counter)
    assert terms["collective_s"] == (stats["total_bytes"]
                                     / analysis.H100.link_bytes_per_s)
    assert analysis.collective_stats() == {
        "total_bytes": 0.0, "per_op_bytes": {}, "per_op_count": {}}


def test_train_step_checks_the_mesh():
    """The batch must split over the mesh's clients; fl arrays take the
    client axes' shape."""
    mesh = mesh_lib.abstract_mesh(4, client=2)
    assert mesh_lib.client_index(mesh) == 2 and mesh.coords == {
        "data": 2, "model": 0}
    assert mesh_lib.client_axes(mesh) == ("data",)
    assert mesh_lib.n_clients(mesh) == 4
    assert mesh_lib.client_group(mesh) is None
    fl = fl_round_arrays(mesh, gammas=np.arange(4.0))
    assert fl["weight"].shape == (4,) and fl["levels"].shape == (4,)
    assert float(fl["weight"][2]) == 2.0
    pod = mesh_lib.Mesh(("pod", "data", "model"),
                        {"pod": 2, "data": 2, "model": 1},
                        {"pod": 1, "data": 0, "model": 0})
    assert mesh_lib.client_axes(pod) == ("pod", "data")
    assert mesh_lib.client_index(pod) == 2
    assert fl_round_arrays(pod)["weight"].shape == (2, 2)
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(R.seeded_model(CFG, 0), mesh=mesh_lib.abstract_mesh(
            3), batch=BATCH, seq=SEQ)


# ------------------------------------------------------------ shard_trials

@pytest.mark.parametrize("group", ["ranks2", "ranks4"])
def test_shard_trials_bit_equal_to_unsharded(request, unsharded, group):
    """Each rank's run of 4 trials over W ranks is the unsharded run's
    TrainLog, bit for bit; indivisible trials raise with the reference's
    message."""
    results = request.getfixturevalue(group)
    world = len(results)
    for r in results:
        runs = r["shard"]["runs"]
        for case, want in unsharded.items():
            for a, b in zip(runs[case], want):
                np.testing.assert_array_equal(a, b)
        assert r["shard"]["indivisible"] == (
            f"shard_trials needs trials (3) divisible by the device count "
            f"({world})")


def test_shard_trials_without_a_group_is_the_unsharded_run(unsharded):
    """Without a process group the sharded run is the one-rank mesh."""
    task, ds, dep, eta, schemes = R.fl_case()
    from repro_torch.fl import FLEngine
    engine = FLEngine(task, ds, dep, eta, shard_trials=True, device="cpu")
    log = engine.run(schemes["ota"], **R.SHARD_RUN)
    np.testing.assert_array_equal(log.global_loss,
                                  unsharded[("ota", "replay", None)][0])


# ------------------------------------------------------------ refusals

def test_refusals_and_a_dying_rank(tmp_path):
    """A "model" axis of more than one rank and the production mesh raise
    naming part B of ROADMAP Queue 1 item 10 step 6; a rank that raises
    while the other waits in a collective becomes the parent's exception,
    with the rank's traceback, and no rank is left running."""
    with pytest.raises(NotImplementedError, match="item 10 step 6, part B"):
        mesh_lib.make_host_mesh(model_axis=2, device_type="cpu")
    with pytest.raises(NotImplementedError, match="item 10 step 6, part B"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh_lib.make_host_mesh(device_type="cpu")
    assert distributed.backend_for("cuda", 2, 1) == "gloo"
    assert distributed.backend_for("cuda", 2, 2) == "nccl"
    assert distributed.backend_for("cpu", 4, 8) == "gloo"
    assert core_dist.world() == (0, 1)
    with pytest.raises(RuntimeError, match="rank 1 stops here") as e:
        distributed.spawn(R.die_job, 2, device="cpu", store_dir=tmp_path,
                          timeout_s=120)
    assert "rank 1 of 2 failed" in str(e.value)
