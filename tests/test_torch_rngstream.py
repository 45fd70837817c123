"""The port's random streams against the reference's, bit for bit.

Threefry keys and uniforms (``repro_torch.core.rngstream``) against
``jax.random`` through ``repro.core.rngstream``; fading, trial generators,
deployments and datasets (NumPy copies) against their originals.
"""
import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.core import channel, rngstream
from repro_torch.data import (SyntheticSpec, make_classification_dataset,
                              partition_by_class)

SEEDS = [0, 5, 2 ** 31 + 7, 2 ** 32 - 1, 2 ** 40 + 3]


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def test_threefry_layout_is_the_pinned_one(ref):
    # the uniform bit layout depends on this flag: a JAX upgrade that flips
    # it must fail here, not drift silently
    assert ref.jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("trial", [0, 1, 3])
def test_base_keys_bit_equal(ref, seed, trial):
    want = np.asarray(ref.rngstream.dither_base_key(seed, trial))
    assert tuple(int(v) for v in want) == rngstream.dither_base_key(seed,
                                                                     trial)
    for tag in (17, 29, 41):
        want = np.asarray(ref.rngstream.stream_base_key(seed, trial, tag))
        got = rngstream.stream_base_key(seed, trial, tag)
        assert tuple(int(v) for v in want) == got


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 650), (65537,),
                                   (2, 70001)])
@pytest.mark.parametrize("seed", [0, 123456789])
def test_uniform_bit_equal(ref, shape, seed):
    jax = ref.jax
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = jax.random.uniform(key, shape, dtype=jax.numpy.float32)
    got = rngstream.uniform(rngstream.fold_in(rngstream.prng_key(seed), 11),
                            shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("n,d", [(1, 1), (6, 650), (10, 7850), (2, 65537),
                                 (3, 1001)])
@pytest.mark.parametrize("seed,trial,t", [(0, 0, 0), (5, 1, 17),
                                          (2 ** 32 - 1, 3, 999)])
def test_dither_block_bit_equal(ref, n, d, seed, trial, t):
    key = ref.rngstream.dither_base_key(seed, trial)
    want = ref.rngstream.dither_block(key, t, n, d)
    got = rngstream.dither_block(rngstream.dither_base_key(seed, trial), t,
                                 n, d)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    # the oracle's float64 view widens the same f32 bits exactly
    np.testing.assert_array_equal(
        ref.rngstream.dither_block_np(seed, trial, t, n, d),
        got.numpy().astype(np.float64))


def test_dither_blocks_batch_rows_match_single_blocks():
    keys = [rngstream.dither_base_key(9, tr) for tr in range(3)]
    batch = rngstream.dither_blocks(keys, 4, 5, 333)
    for tr, key in enumerate(keys):
        np.testing.assert_array_equal(
            batch[tr].numpy(), rngstream.dither_block(key, 4, 5, 333).numpy())


@pytest.mark.parametrize("seed", [0, 5001, 123])
def test_fading_and_trial_rng_bit_equal(ref, seed):
    lambdas = np.geomspace(1e-9, 1e-6, 7)
    np.testing.assert_array_equal(
        ref.channel.sample_fading_batch(lambdas, seed, 12),
        channel.sample_fading_batch(lambdas, seed, 12))
    for trial in (0, 2):
        np.testing.assert_array_equal(
            ref.rngstream.trial_rng(seed, trial).standard_normal((4, 650)),
            rngstream.trial_rng(seed, trial).standard_normal((4, 650)))


def test_deployment_and_data_bit_equal(ref):
    dep_r = ref.channel.make_deployment(ref.channel.WirelessConfig(
        n_devices=8, seed=1))
    dep_p = channel.make_deployment(channel.WirelessConfig(n_devices=8,
                                                           seed=1))
    np.testing.assert_array_equal(dep_r.lambdas, dep_p.lambdas)
    np.testing.assert_array_equal(dep_r.distances_m, dep_p.distances_m)
    kw = dict(image_shape=(8, 8, 1), n_train_per_class=30,
              n_test_per_class=10, noise_sigma=1.5)
    data_r = ref.synthetic.make_classification_dataset(
        ref.synthetic.SyntheticSpec(**kw))
    data_p = make_classification_dataset(SyntheticSpec(**kw))
    for a, b in zip(data_r, data_p):
        np.testing.assert_array_equal(a, b)
    shards_r = ref.partition.partition_by_class(data_r[0], data_r[1], 6, 1,
                                                30, seed=3)
    shards_p = partition_by_class(data_p[0], data_p[1], 6, 1, 30, seed=3)
    for (xr, yr), (xp, yp) in zip(shards_r, shards_p):
        np.testing.assert_array_equal(xr, xp)
        np.testing.assert_array_equal(yr, yp)
