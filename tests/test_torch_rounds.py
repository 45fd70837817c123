"""One uplink round of each Fig. 2 scheme: the port against the reference
on the same reference-made f64 gradients, fading, AWGN and dither.

``ota_round`` vs ``ota_round_jax``, Vanilla OTA's engine port vs the
reference engine's, ``digital_round`` vs ``digital_round_jax`` (kernels
in interpret mode, f64 under x64 as the engine runs them). The port runs
two trials as one batch. Tolerances: participation masks equal; ghat
within 1e-12 relative (the gamma-weighted sums add the devices in another
order); digital latency equal.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import baselines as B
from repro_torch.core.digital import digital_round
from repro_torch.core.ota import ota_round
from repro_torch.fl.engine import scheme_port

pytestmark = pytest.mark.usefixtures("one_thread")

N, D_IMG, TRIALS = 6, (8, 8, 1), 2


@pytest.fixture(scope="module")
def case(ref):
    """Reference deployment, designed parameters and per-trial inputs."""
    spec = ref.synthetic.SyntheticSpec(image_shape=D_IMG,
                                       n_train_per_class=30,
                                       n_test_per_class=10, noise_sigma=1.5)
    x, y, _, _ = ref.synthetic.make_classification_dataset(spec)
    shards = ref.partition.partition_by_class(x, y, N, 1, 30, seed=3)
    xs = np.stack([s[0] for s in shards])
    ys = np.stack([s[1] for s in shards])
    task = ref.tasks.SoftmaxRegressionTask(n_features=int(np.prod(D_IMG)))
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(n_devices=N,
                                                                 seed=1))
    cfg = dep.cfg
    w = ref.bounds.ObjectiveWeights.strongly_convex(eta=0.1, mu=task.mu,
                                                    kappa_sc=3.0, n=N)
    ospec = ref.ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = ref.digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2, weights=w)
    rng = np.random.default_rng(0)
    grads = np.stack([task.device_grads(rng.normal(size=task.dim) * 0.1,
                                        xs, ys) for _ in range(TRIALS)])
    t = 3
    h = np.stack([ref.channel.sample_fading_batch(dep.lambdas, 1000 * 5 + tr,
                                                  t + 1)[t]
                  for tr in range(TRIALS)])
    z01 = np.stack([ref.rngstream.trial_rng(5, tr).standard_normal(
        (t + 1, task.dim))[t] for tr in range(TRIALS)])
    u = np.stack([np.asarray(ref.rngstream.dither_block(
        ref.rngstream.dither_base_key(5, tr), t, N, task.dim))
        for tr in range(TRIALS)])
    return dict(
        task=task, dep=dep, cfg=cfg, grads=grads, h=h, z01=z01, u=u,
        ota=[ref.ota_design.params_from_gamma(ospec, anchor(ospec))
             for anchor in (ref.ota_design.anchor_min_noise,
                            ref.ota_design.anchor_zero_bias)],
        digital=ref.digital_design.finalize(
            dspec, *ref.digital_design.anchor_uniform(dspec)))


def _port_inputs(c):
    return (torch.from_numpy(c["grads"]), torch.from_numpy(np.abs(c["h"])),
            torch.from_numpy(c["z01"]), torch.from_numpy(c["u"]))


def _assert_rel(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want))


@pytest.mark.parametrize("which", [0, 1], ids=["min_noise", "zero_bias"])
def test_ota_round_matches_reference(ref, case, which):
    params = case["ota"][which]
    g, habs, z01, _ = _port_inputs(case)
    ghat, chi = ota_round(interop.ota_params(params), g, habs, z01)
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        for tr in range(TRIALS):
            want_g, want_chi = ref.ota.ota_round_jax(
                params, jnp.asarray(case["grads"][tr]),
                jnp.asarray(case["h"][tr]), jnp.asarray(case["z01"][tr]),
                use_kernel=True)
            np.testing.assert_array_equal(chi[tr].numpy(),
                                          np.asarray(want_chi))
            _assert_rel(ghat[tr].numpy(), want_g)


def test_vanilla_ota_round_matches_reference_engine(ref, case):
    cfg, task = case["cfg"], case["task"]
    agg_r = ref.baselines.VanillaOTA(task.dim, task.g_max,
                                     cfg.energy_per_symbol, cfg.noise_power)
    port = scheme_port(interop.scheme(agg_r))
    g, habs, z01, u = _port_inputs(case)
    ghat, lat = port.round_fn(g, habs, z01, u, None, 3)
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        fn = ref.engine.as_functional(agg_r, use_kernel=True).round_fn
        for tr in range(TRIALS):
            want_g, want_lat = fn(jnp.asarray(case["grads"][tr]),
                                  jnp.asarray(case["h"][tr]),
                                  jnp.asarray(case["z01"][tr]),
                                  jnp.asarray(case["u"][tr]),
                                  jnp.zeros(1), 3)
            _assert_rel(ghat[tr].numpy(), want_g)
            assert lat == want_lat


def test_ideal_fedavg_round_is_the_mean(case):
    g, habs, z01, u = _port_inputs(case)
    ghat, lat = scheme_port(B.IdealFedAvg()).round_fn(g, habs, None, u,
                                                      None, 3)
    _assert_rel(ghat.numpy(), case["grads"].mean(axis=1))
    assert lat == 0.0


def test_digital_round_matches_reference(ref, case):
    params = case["digital"]
    g, habs, _, u = _port_inputs(case)
    ghat, chi, lat = digital_round(interop.digital_params(params), g, habs, u)
    assert 0 < chi.sum() < chi.numel()      # a mix of in- and outages
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        for tr in range(TRIALS):
            want_g, want_chi, want_lat = ref.digital.digital_round_jax(
                params, jnp.asarray(case["grads"][tr]),
                jnp.asarray(case["h"][tr]), jnp.asarray(case["u"][tr]),
                use_kernel=True)
            np.testing.assert_array_equal(chi[tr].numpy(),
                                          np.asarray(want_chi))
            _assert_rel(ghat[tr].numpy(), want_g)
            assert float(lat[tr]) == float(want_lat)
