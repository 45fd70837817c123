"""What the port's engine-layer tests share (``test_torch_faults.py``,
``test_torch_participation.py``, ``test_torch_async.py``).

The cell is the trainer tests' (8x8 images, d = 650, N = 6 devices of one
class, Fig. 2's deployment seed), built by the reference and carried into
the port with ``repro_torch.interop``. Three checks:

  * ``run_both``: one scheme under one layer configuration through both
    trainers, the port on the CPU and the reference's JAX engine
    (``backend="jax"``, Pallas in interpret mode);
  * ``assert_ota_close``: OTA trajectories within 1e-5 relative at every
    round (``eval_every=1``), the wall-clock equal, accuracy within one
    test sample; ``digital_gate``: the digital schemes' mean loss within
    4 combined standard errors and 1e-3 relative;
  * ``check_layered_round``: reference-made gradients through the port's
    layers (``fl.engine._Layers``) against the reference engine's layer
    code written out on the reference's own functions and streams,
    bit for bit, then one digital round on those payloads against
    ``digital_round_jax``: masks and latency equal, ghat within 1e-12
    relative, and every row a layer zeroed quantized to exact zeros in
    both packages.
"""
import numpy as np
import torch

from repro_torch import interop
from repro_torch.core.digital import digital_round
from repro_torch.fl import FLEngine, FLTrainer, SoftmaxRegressionTask
from repro_torch.fl.engine import _Layers
from repro_torch.kernels import ops

N = 6
SEED = 5
#: every round is an eval point, so trajectories compare round by round
RUN = dict(rounds=12, trials=2, eval_every=1, seed=SEED)
OTA_RTOL = 1e-5
#: the reference's full fault model (``tests/test_faults.py``)
FULL_FAULT = dict(dropout_prob=0.3, erasure_prob=0.1, deep_fade_thresh=1e-6,
                  straggler_prob=0.2, straggler_mult=2.5)


def make_case(ref):
    spec = ref.synthetic.SyntheticSpec(image_shape=(8, 8, 1),
                                       n_train_per_class=200,
                                       n_test_per_class=50, noise_sigma=1.5)
    x_tr, y_tr, x_te, y_te = ref.synthetic.make_classification_dataset(spec)
    shards = ref.partition.partition_by_class(x_tr, y_tr, N, 1, 200, seed=3)
    ds = ref.loader.FLDataset.from_shards(shards, x_te, y_te)
    task = ref.tasks.SoftmaxRegressionTask(n_features=64, mu=0.01,
                                           g_max=20.0)
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(n_devices=N,
                                                                 seed=1))
    cfg = dep.cfg
    eta = 0.5 / (task.mu + task.smooth_l)
    w = ref.bounds.ObjectiveWeights.strongly_convex(eta=eta, mu=task.mu,
                                                    kappa_sc=3.0, n=N)
    ospec = ref.ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = ref.digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2, weights=w)
    b = ref.baselines
    return dict(
        ref=ref, task=task, ds=ds, dep=dep, eta=eta,
        ota=b.ProposedOTA(ref.ota_design.params_from_gamma(
            ospec, ref.ota_design.anchor_min_noise(ospec))),
        vanilla=b.VanillaOTA(task.dim, task.g_max, cfg.energy_per_symbol,
                             cfg.noise_power),
        digital=b.ProposedDigital(ref.digital_design.finalize(
            dspec, *ref.digital_design.anchor_uniform(dspec))),
        port_task=SoftmaxRegressionTask(n_features=64, mu=0.01, g_max=20.0),
        port_ds=interop.dataset(ds), port_dep=interop.deployment(dep))


def port_kwargs(kw: dict) -> dict:
    """The reference's layer options in the port's types."""
    out = dict(kw)
    if kw.get("fault") is not None:
        out["fault"] = interop.fault_spec(kw["fault"])
    if kw.get("async_spec") is not None:
        out["async_spec"] = interop.async_spec(kw["async_spec"])
    return out


def port_trainer(case, **kw) -> FLTrainer:
    return FLTrainer(case["port_task"], case["port_ds"], case["port_dep"],
                     case["eta"], device="cpu", **port_kwargs(kw))


def run_port(case, agg, run=RUN, **kw):
    return port_trainer(case, **kw).run(interop.scheme(agg), **run)


def run_both(case, agg, run=RUN, **kw):
    """(port log, reference log) of one scheme under the layer options
    ``kw`` (reference types)."""
    ref = case["ref"]
    log_r = ref.trainer.FLTrainer(case["task"], case["ds"], case["dep"],
                                  eta=case["eta"], **kw).run(
        agg, backend="jax", **run)
    return run_port(case, agg, run, **kw), log_r


def assert_ota_close(log_p, log_r, n_test):
    assert log_p.scheme == log_r.scheme
    np.testing.assert_array_equal(log_p.rounds, log_r.rounds)
    np.testing.assert_array_equal(log_p.wall_time_s, log_r.wall_time_s)
    np.testing.assert_allclose(log_p.global_loss, log_r.global_loss,
                               rtol=OTA_RTOL, atol=0)
    assert np.max(np.abs(log_p.accuracy - log_r.accuracy)) \
        <= 1.0 / n_test + 1e-6
    assert np.all(np.isfinite(log_p.global_loss))


def digital_gate(log_p, log_r, n_samples):
    """Mean loss within 4 combined standard errors of the trial means (a
    floor of ceil(log2 n) f32 ulps where no trial spreads) and 1e-3
    relative; wall-clocks within 8 ulps (the capacity rates' logs)."""
    lp, lr = log_p.global_loss, log_r.global_loss
    trials = lp.shape[0]
    stderr = np.sqrt((lp.var(0) + lr.var(0)) / (trials - 1))
    mr = lr.mean(0)
    floor = np.ceil(np.log2(n_samples)) * np.spacing(
        np.float32(mr)).astype(np.float64)
    gap = np.abs(lp.mean(0) - mr)
    assert np.all(gap <= 4.0 * stderr + floor), (gap, stderr)
    np.testing.assert_allclose(lp.mean(0), mr, rtol=1e-3, atol=0)
    np.testing.assert_allclose(log_p.wall_time_s, log_r.wall_time_s,
                               rtol=8 * np.finfo(np.float64).eps, atol=0)
    assert np.all(np.isfinite(lp))


def _reference_layers(ref, trainer, fault, g, t, habs, state, seed):
    """The reference engine's layer code (``repro/fl/engine.py:796-848``)
    for one trial's round on NumPy, on the reference's own functions and
    streams; ``state`` carries its buffers across rounds."""
    jnp = ref.jax.numpy
    tr, n = state["trial"], g.shape[0]
    if state["bf16"]:
        with ref.jax.enable_x64():
            g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                           .astype(jnp.float64))
    part = trainer.participation
    if part is not None:
        up = ref.rngstream.participation_block_np(seed, tr, t, n)
        chi = up < part.probs_array()
        g = g * (chi.astype(np.float64) * part.scale)[:, None]
    asy = trainer.async_
    if asy is not None:
        ua = ref.rngstream.arrival_block_np(seed, tr, t, n)
        g, ok, state["a_buf"] = ref.async_fl.async_round(
            g, state["a_buf"], ua, asy.rates_array(), asy.cdf_array(),
            asy.discounts_array(), asy.payload_scale_array())
        if asy.on_missing == "stale":
            g, state["g_alast"] = ref.async_fl.stale_replace(
                g, ok, state["g_alast"])
        else:
            g = g * ok.astype(np.float64)[:, None]
    if fault is not None:
        uf = ref.rngstream.fault_block_np(seed, tr, t, n)
        okb, _ = ref.faults.fault_masks(uf, habs, fault)
        if fault.on_missing == "zero":
            g = g * okb.astype(np.float64)[:, None]
        elif fault.on_missing == "reweight":
            q = ref.faults.survival_prob(fault, trainer.dep.lambdas)
            g = g * (okb.astype(np.float64) / q)[:, None]
        else:
            g, state["g_stale"] = ref.async_fl.stale_replace(
                g, okb, state["g_stale"])
    return g


def check_layered_round(case, rounds=6, trials=2, **kw):
    """Reference-made gradients through both packages' layers for
    ``rounds`` rounds (payloads bit-equal, trials batched in the port),
    each round's payloads then through one ProposedDigital round in both
    packages. Returns the number of rows a layer zeroed."""
    ref = case["ref"]
    task, dep = case["task"], case["dep"]
    d = task.dim
    fault = kw.get("fault")
    fault = fault if fault is not None and fault.enabled else None
    trainer = ref.trainer.FLTrainer(task, case["ds"], dep, eta=case["eta"],
                                    **kw)
    engine = FLEngine(case["port_task"], case["port_ds"], case["port_dep"],
                      case["eta"], device="cpu", **port_kwargs(kw))
    layers = _Layers(engine, SEED, trials, rounds)
    states = []
    for tr in range(trials):
        st = dict(trial=tr, bf16=kw.get("payload_dtype") == "bf16")
        if trainer.async_ is not None:
            st["a_buf"] = np.zeros((trainer.async_.buffer_rounds, N, d))
            st["g_alast"] = np.zeros((N, d))
        st["g_stale"] = np.zeros((N, d))
        states.append(st)
    h = np.stack([ref.channel.sample_fading_batch(
        dep.lambdas, SEED * 1000 + tr, rounds) for tr in range(trials)])
    habs = np.abs(h)
    params = case["digital"].params
    port_params = interop.digital_params(params)
    levels = torch.as_tensor(2.0 ** params.r_bits.astype(np.float64) - 1.0)
    rng = np.random.default_rng(11)
    zeroed = 0
    jnp = ref.jax.numpy
    for t in range(rounds):
        g = rng.normal(size=(trials, N, d)).astype(np.float32).astype(
            np.float64)
        want = np.stack([_reference_layers(ref, trainer, fault, g[tr], t,
                                           habs[tr, t], states[tr], SEED)
                         for tr in range(trials)])
        got = layers.payloads(torch.from_numpy(g), t,
                              torch.from_numpy(habs[:, t]))
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      want.view(np.int64))
        zero_rows = ~np.any(want != 0.0, axis=-1)
        zeroed += int(zero_rows.sum())
        u = np.stack([np.asarray(ref.rngstream.dither_block(
            ref.rngstream.dither_base_key(SEED, tr), t, N, d))
            for tr in range(trials)])
        ghat, chi, lat = digital_round(port_params, got,
                                       torch.from_numpy(habs[:, t]),
                                       torch.from_numpy(u))
        q_p = ops.dithered_quantize_batch(
            got.reshape(-1, d), levels.repeat(trials),
            torch.from_numpy(u).reshape(-1, d)).reshape(trials, N, d)
        with ref.jax.enable_x64():
            for tr in range(trials):
                want_g, want_chi, want_lat = ref.digital.digital_round_jax(
                    params, jnp.asarray(want[tr]), jnp.asarray(h[tr, t]),
                    jnp.asarray(u[tr]), use_kernel=True)
                np.testing.assert_array_equal(chi[tr].numpy(),
                                              np.asarray(want_chi))
                assert float(lat[tr]) == float(want_lat)
                scale = np.max(np.abs(np.asarray(want_g)))
                assert np.max(np.abs(ghat[tr].numpy() - np.asarray(want_g))) \
                    <= 1e-12 * scale
                q_r = np.asarray(ref.ops.dithered_quantize_batch(
                    jnp.asarray(want[tr]), jnp.asarray(levels.numpy()),
                    jnp.asarray(u[tr])))
                for m in np.flatnonzero(zero_rows[tr]):
                    assert np.all(q_r[m] == 0.0)
                    assert np.all(q_p[tr, m].numpy() == 0.0)
    return zeroed
