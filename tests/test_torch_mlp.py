"""The port's ``MLPTask`` (Fig. 3's non-convex task) against the
reference's ``repro.fl.tasks.MLPTask`` on the same numpy-made weights and
data.

Tolerances: ``init_params`` bit-equal (the same numpy draws); clipped f32
gradients within 1e-5 * max|g| (measured 2.8e-7 at full width: torch and
XLA sum the f32 products in other orders); loss within 1e-6 relative;
accuracy within 1/n (an f32 logit tie may break the other way).
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.fl import MLPTask, SoftmaxRegressionTask

pytestmark = pytest.mark.usefixtures("one_thread")

SIZES = [(64, 8, 3, 20), (3072, 48, 2, 100)]      # (F, H, devices, samples)
SIZE_IDS = ["small", "fig3-width"]
G_MAX = {64: 0.5, 3072: 49.0}         # small: every gradient is clipped


def _data(F, N, n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, n, F)).astype(np.float32)
    ys = rng.integers(0, 10, size=(N, n))
    return xs, ys


def _weights(task_r, k, seed):
    """k models near the reference's w0, so ReLUs both fire and not."""
    rng = np.random.default_rng(seed)
    w0 = task_r.init_params()
    return w0 + 0.05 * rng.normal(size=(k, task_r.dim)) * np.abs(w0).max()


@pytest.mark.parametrize("seed", [None, 0, 3])
@pytest.mark.parametrize("F,H", [(64, 8), (3072, 48)])
def test_init_params_bit_equal(ref, F, H, seed):
    task_r = ref.tasks.MLPTask(F, H, seed=5)
    task_p = MLPTask(F, H, seed=5)
    w_p = task_p.init_params(seed=seed)
    assert w_p.dtype == torch.float64 and w_p.shape == (task_r.dim,)
    np.testing.assert_array_equal(w_p.numpy(), task_r.init_params(seed))


@pytest.mark.parametrize("F,H,N,n", SIZES, ids=SIZE_IDS)
def test_device_grads_match_reference(ref, F, H, N, n):
    task_r = ref.tasks.MLPTask(F, H, g_max=G_MAX[F])
    task_p = MLPTask(F, H, g_max=G_MAX[F])
    xs, ys = _data(F, N, n, seed=F)
    ws = _weights(task_r, 3, seed=H)
    got = task_p.device_grads(torch.tensor(ws, dtype=torch.float32),
                              torch.from_numpy(xs), torch.from_numpy(ys))
    assert got.shape == (3, N, task_r.dim) and got.dtype == torch.float32
    for k in range(3):
        want = task_r.device_grads(ws[k], xs, ys)
        if F == 64:
            np.testing.assert_allclose(np.linalg.norm(want, axis=1), 0.5,
                                       rtol=1e-6)
        np.testing.assert_allclose(got[k].double().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # one model: (d,) -> (N, d)
    one = task_p.device_grads(torch.tensor(ws[0], dtype=torch.float32),
                              torch.from_numpy(xs), torch.from_numpy(ys))
    assert one.shape == (N, task_r.dim)
    torch.testing.assert_close(one, got[0], rtol=0, atol=1e-6)


def test_relu_passes_no_gradient_at_zero(ref):
    # a hidden unit whose pre-activation is exactly 0 on every sample:
    # jax.nn.relu's derivative there is 0, so W1's column and b1 get only
    # the mu*w term
    F, H = 16, 4
    task_r, task_p = ref.tasks.MLPTask(F, H, g_max=1e9), MLPTask(F, H,
                                                                   g_max=1e9)
    xs, ys = _data(F, 2, 8, seed=1)
    w = task_r.init_params()
    w[np.arange(F) * H] = 0.0                   # W1[:, 0] = 0, b1[0] = 0
    w[F * H] = 0.0
    got = task_p.device_grads(torch.tensor(w, dtype=torch.float32),
                              torch.from_numpy(xs), torch.from_numpy(ys))
    want = task_r.device_grads(w, xs, ys)
    assert np.all(got.numpy()[:, np.arange(F) * H] == 0.0)
    assert np.all(got.numpy()[:, F * H] == 0.0)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("F,H,N,n", SIZES, ids=SIZE_IDS)
def test_loss_and_accuracy_match_reference(ref, F, H, N, n):
    task_r, task_p = ref.tasks.MLPTask(F, H), MLPTask(F, H)
    xs, ys = _data(F, N, n, seed=F + 1)
    x, y = xs.reshape(-1, F), ys.reshape(-1)
    ws = _weights(task_r, 3, seed=H + 1)
    w32 = torch.tensor(ws, dtype=torch.float32)
    losses = task_p.loss(w32, torch.from_numpy(x), torch.from_numpy(y))
    accs = task_p.accuracy(w32, torch.from_numpy(x), torch.from_numpy(y))
    assert losses.shape == accs.shape == (3,)
    assert losses.dtype == accs.dtype == torch.float32
    for k in range(3):
        assert float(losses[k]) == pytest.approx(
            task_r.global_loss(ws[k], x, y), rel=1e-6)
        assert float(accs[k]) == pytest.approx(
            task_r.accuracy(ws[k], x, y), abs=1.0 / len(y) + 1e-7)
    assert float(task_p.loss(w32[0], torch.from_numpy(x),
                             torch.from_numpy(y))) == float(losses[0])


@pytest.mark.parametrize("kind", ["mlp", "softmax"])
def test_weights_carry_across_both_ways(ref, kind):
    if kind == "mlp":
        task_r, task_p = ref.tasks.MLPTask(64, 8), MLPTask(64, 8)
    else:
        task_r = ref.tasks.SoftmaxRegressionTask(n_features=64)
        task_p = SoftmaxRegressionTask(n_features=64)
    w = np.random.default_rng(2).normal(size=task_r.dim)
    interop.load_weights(task_p, w)
    np.testing.assert_array_equal(interop.flat_weights(task_p), w)
    # the module's forward runs the loaded model, as the functional path
    xs, ys = _data(64, 1, 30, seed=4)
    x, y = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    logits = task_p(x)
    assert logits.shape == (30, 10)
    w32 = torch.tensor(w, dtype=torch.float32)
    assert float((logits.argmax(-1) == y).float().mean()) == \
        float(task_p.accuracy(w32, x, y))
    with pytest.raises(ValueError):
        interop.load_weights(task_p, w[:-1])


def test_mlp_layout_is_the_reference_unpack(ref):
    task_r, task_p = ref.tasks.MLPTask(64, 8), MLPTask(64, 8)
    w = np.arange(task_r.dim, dtype=np.float64)
    interop.load_weights(task_p, w)
    with ref.jax.enable_x64():
        parts = [np.asarray(p) for p in task_r._unpack(w)]
    for got, want in zip((task_p.W1, task_p.b1, task_p.W2, task_p.b2), parts):
        np.testing.assert_array_equal(got.numpy(), want)
