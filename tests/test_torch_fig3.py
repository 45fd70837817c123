"""The paper's Fig. 3 setup at full width through the port's trainer on the
CPU, against the reference engine (``FLTrainer.run(backend="jax")``).

The setup is ``benchmarks/common.py::make_nc_setup``'s: CIFAR-like data
(32x32x3), N = 10 devices with 2 classes and 100 samples each,
``MLPTask`` 3072 -> 48 -> 10 (d = 147,994), eta = 0.08. Parameters come
from the closed-form anchors (min-noise OTA; uniform digital at
beta0 = 0.15 and t_max = 3 s, which gives every device 7 bits, so the
digital path packs 8-bit codes) under ``ObjectiveWeights.non_convex`` with
L = 10 and kappa_nc = 3 (the anchors do not read the weights). One trial,
6 rounds. At d >= 2^17 both packages take the fused quantize-pack route.

Tolerances: ProposedOTA's loss within 1e-5 relative at every eval point
(torch and XLA f32 gradients differ in the last ulps); ProposedDigital's
within 1e-3 (those ulps may flip a dither code), after a bit-for-bit
check of its codes on reference-made gradients; accuracy within 1 and 2
test samples; wall-clocks equal.
"""
import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch import interop
from repro_torch.core.digital import digital_round
from repro_torch.fl import FLEngine, FLTrainer, MLPTask
from repro_torch.kernels import ops, payload

N, SEED = 10, 9
RUN = dict(rounds=6, trials=1, eval_every=2, seed=SEED)


@pytest.fixture(scope="module")
def setup(ref):
    spec = ref.synthetic.SyntheticSpec(
        name="cifar-like", image_shape=(32, 32, 3), n_train_per_class=120,
        n_test_per_class=100, noise_sigma=1.8, seed=7)
    x_tr, y_tr, x_te, y_te = ref.synthetic.make_classification_dataset(spec)
    shards = ref.partition.partition_by_class(x_tr, y_tr, N, 2, 100, seed=5)
    ds = ref.loader.FLDataset.from_shards(shards, x_te, y_te)
    task = ref.tasks.MLPTask(n_features=3072, hidden=48, mu_nc=0.01,
                             g_max=49.0)
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(n_devices=N,
                                                                 seed=1))
    cfg, eta = dep.cfg, 0.08
    w = ref.bounds.ObjectiveWeights.non_convex(eta=eta, smooth_l=10.0,
                                               kappa_nc=3.0, n=N)
    ospec = ref.ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = ref.digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=3.0, weights=w)
    schemes = {
        "ota": ref.baselines.ProposedOTA(ref.ota_design.params_from_gamma(
            ospec, ref.ota_design.anchor_min_noise(ospec))),
        "digital": ref.baselines.ProposedDigital(ref.digital_design.finalize(
            dspec, *ref.digital_design.anchor_uniform(dspec, beta0=0.15))),
    }
    port_task = MLPTask(n_features=3072, hidden=48, mu_nc=0.01, g_max=49.0)
    port_args = (port_task, interop.dataset(ds), interop.deployment(dep), eta)
    return dict(schemes=schemes, task=task, ds=ds, dep=dep,
                ref_trainer=ref.trainer.FLTrainer(task, ds, dep, eta=eta),
                port_args=port_args,
                port_trainer=FLTrainer(*port_args, device="cpu"))


def _compare(log_p, log_r, n_test, loss_rel, acc_steps):
    assert log_p.scheme == log_r.scheme
    np.testing.assert_array_equal(log_p.rounds, log_r.rounds)
    np.testing.assert_array_equal(log_p.wall_time_s, log_r.wall_time_s)
    assert log_p.global_loss.shape == log_r.global_loss.shape == (1, 4)
    np.testing.assert_allclose(log_p.global_loss, log_r.global_loss,
                               rtol=loss_rel, atol=0)
    assert np.max(np.abs(log_p.accuracy - log_r.accuracy)) \
        <= acc_steps / n_test + 1e-6
    # the model learns from the reference's own w0
    assert log_p.global_loss[0, -1] < log_p.global_loss[0, 0]


def test_design_gives_8_bit_codes(setup):
    r_bits = setup["schemes"]["digital"].params.r_bits
    assert setup["task"].dim == 147994 >= ops.FUSED_MIN_DIM
    assert ops.code_bits_for(r_bits.max()) == 8 and 5 <= r_bits.min()


def test_engine_starts_from_the_reference_w0(setup):
    task_r, task_p = setup["task"], setup["port_args"][0]
    w0 = task_p.init_params()
    np.testing.assert_array_equal(w0.numpy(), task_r.init_params())
    ds = setup["ds"]
    x = np.concatenate([d.x for d in ds.devices])
    y = np.concatenate([d.y for d in ds.devices])
    log = setup["port_trainer"].run(interop.scheme(setup["schemes"]["ota"]),
                                    rounds=1, trials=1, eval_every=1,
                                    seed=SEED)
    assert log.global_loss[0, 0] == float(task_p.loss(
        w0.float(), torch.from_numpy(x), torch.from_numpy(y)))


def test_ota_trajectory_matches_reference(setup):
    agg = setup["schemes"]["ota"]
    log_r = setup["ref_trainer"].run(agg, backend="jax", **RUN)
    log_p = setup["port_trainer"].run(interop.scheme(agg), **RUN)
    _compare(log_p, log_r, len(setup["ds"].y_test), 1e-5, 1)


def test_digital_codes_bit_equal_on_reference_gradients(ref, setup):
    # round 0 of trial 0: reference gradients at w0, the reference's
    # dither block and fading; both packages pack on the fused route
    params = setup["schemes"]["digital"].params
    task, ds, dep = setup["task"], setup["ds"], setup["dep"]
    xs = np.stack([d.x for d in ds.devices])
    ys = np.stack([d.y for d in ds.devices])
    g = task.device_grads(task.init_params(), xs, ys)
    u = np.array(ref.rngstream.dither_block(
        ref.rngstream.dither_base_key(SEED, 0), 0, N, task.dim))
    h = ref.channel.sample_fading_batch(dep.lambdas, SEED * 1000, 1)[0]
    levels = 2.0 ** params.r_bits.astype(np.float64) - 1.0
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        pk_r = ref.ops.quantize_pack(jnp.asarray(g), jnp.asarray(levels),
                                     jnp.asarray(u), code_bits=8)
        want_g, want_chi, want_lat = ref.digital.digital_round_jax(
            params, jnp.asarray(g), jnp.asarray(h), jnp.asarray(u),
            use_kernel=True)
    pk_p = ops.quantize_pack(torch.from_numpy(g), torch.from_numpy(levels),
                             torch.from_numpy(u), code_bits=8)
    assert torch.equal(pk_p.words, interop.packed_grads(pk_r).words)
    ghat, chi, lat = digital_round(
        interop.digital_params(params), torch.from_numpy(g)[None],
        torch.from_numpy(np.abs(h))[None], torch.from_numpy(u)[None])
    np.testing.assert_array_equal(chi[0].numpy(), np.asarray(want_chi))
    assert 0 < float(chi.sum()) < N          # a mix of in- and outages
    assert float(lat[0]) == float(want_lat)
    # the fused sums differ only where XLA contracts -m + safe*q and
    # acc + w*v into FMAs: within 4 ulp of sum_i |w_i| (|v_i| + m_i)
    w = chi[0].numpy() / params.nus
    v = ops.unpack_dequant(pk_p).numpy()
    m = np.abs(g).max(axis=1, keepdims=True)
    scale = np.sum(np.abs(w[:, None]) * (np.abs(v) + m), axis=0)
    assert np.all(np.abs(ghat[0].numpy() - np.asarray(want_g))
                  <= 4 * np.spacing(scale))


def test_digital_trajectory_matches_reference(setup, monkeypatch):
    calls = {"pack": 0, "wsum": 0, "two_step": 0}

    def spy(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(payload, "quantize_pack_rows",
                        spy("pack", payload.quantize_pack_rows))
    monkeypatch.setattr(payload, "packed_weighted_sum",
                        spy("wsum", payload.packed_weighted_sum))
    monkeypatch.setattr(ops, "dithered_quantize_rows",
                        spy("two_step", ops.dithered_quantize_rows))
    agg = setup["schemes"]["digital"]
    log_p = setup["port_trainer"].run(interop.scheme(agg), **RUN)
    # the fused route: one pack and one weighted sum a round, for all
    # trials and devices; the two-step quantizer never runs
    assert calls == {"pack": 6, "wsum": 6, "two_step": 0}
    log_r = setup["ref_trainer"].run(agg, backend="jax", **RUN)
    _compare(log_p, log_r, len(setup["ds"].y_test), 1e-3, 2)


def test_digital_plain_run_is_bit_equal(setup, monkeypatch):
    # use_kernel=False: the sequential plain version of the fused route,
    # with no packing and no two-step matvec
    agg = interop.scheme(setup["schemes"]["digital"])
    run = dict(RUN, rounds=4)
    log = setup["port_trainer"].run(agg, **run)
    seq = []
    real = ops.ref.quantized_weighted_sum_ref
    monkeypatch.setattr(ops.ref, "quantized_weighted_sum_ref",
                        lambda *a: seq.append(1) or real(*a))
    monkeypatch.setattr(ops, "dithered_quantize_batch", None)
    monkeypatch.setattr(payload, "quantize_pack_rows", None)
    plain = FLEngine(*setup["port_args"], use_kernel=False,
                     device="cpu").run(agg, **run)
    assert len(seq) == 4
    np.testing.assert_array_equal(plain.global_loss, log.global_loss)
    np.testing.assert_array_equal(plain.wall_time_s, log.wall_time_s)
