"""The port's first-order linear scan (``repro_torch.kernels``: the plain
version ``ref.linear_scan_ref``, the wrapper of the CUDA kernel
``linear_scan`` and its caller ``ops.linear_scan``) on the CPU against the
JAX reference's oracle ``repro.kernels.ref.linear_scan_ref`` and its
Pallas kernel ``linear_scan_fsl`` (through ``repro.kernels.ops.linear_scan``
in interpret mode), on numpy-made inputs.

Tolerance: atol 2e-5, the reference's own bound for its kernel against its
oracle (``tests/test_kernels.py``); the Pallas kernel composes the steps
in a Hillis-Steele order and XLA may contract a product and a sum into an
FMA, so neither is bit-equal to a sequential loop. The order the CUDA
kernel repeats, one step at a time, the product and the sum each rounded,
is pinned bit for bit against a numpy float32 loop, also at shapes where
the CUDA kernel's tiles end unevenly. On the card ``chip_smoke.py`` holds
the kernel bit-equal to the plain version, its tile edges included.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import kernels
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as kref

pytestmark = pytest.mark.usefixtures("one_thread")

SHAPES = [(1, 16, 8), (2, 300, 200), (3, 256, 128), (2, 1024, 64),
          (1, 37, 129)]
ATOL = 2e-5


def _inputs(B, S, D, seed=0):
    rng = np.random.default_rng([B, S, D, seed])
    a = rng.uniform(0.3, 0.999, (B, S, D)).astype(np.float32)
    b = (rng.normal(size=(B, S, D)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    return a, b, h0


def _numpy_loop(a, b, h0):
    """The kernel's order: a multiply, then an add, each rounded to f32."""
    h = h0.copy()
    out = np.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h
        h = h + b[:, t]
        out[:, t] = h
    return out, h


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_plain_matches_reference_oracle_and_pallas_kernel(ref, B, S, D):
    a, b, h0 = _inputs(B, S, D)
    jnp = ref.jax.numpy
    ja, jb, jh = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    mine_all, mine_last = kref.linear_scan_ref(*map(torch.from_numpy,
                                                    (a, b, h0)))
    assert mine_all.dtype == mine_last.dtype == torch.float32
    assert mine_all.shape == (B, S, D) and mine_last.shape == (B, D)
    for r_all, r_last in (ref.ref.linear_scan_ref(ja, jb, jh),
                          ref.ops.linear_scan(ja, jb, jh, use_kernel=True)):
        np.testing.assert_allclose(mine_all.numpy(), np.asarray(r_all),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(mine_last.numpy(), np.asarray(r_last),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(mine_last.numpy(), mine_all[:, -1].numpy())


def test_identity_dynamics(ref):
    """a = 1, b = 0 gives h_t = h0 for all t, exactly; the reference's
    kernel too within its 1e-6."""
    B, S, D = 2, 512, 128
    h0 = np.random.default_rng(0).normal(size=(B, D)).astype(np.float32)
    a, b = np.ones((B, S, D), np.float32), np.zeros((B, S, D), np.float32)
    h_all, h_last = ops.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(h0))
    want = np.broadcast_to(h0[:, None], (B, S, D))
    np.testing.assert_array_equal(h_all.numpy(), want)
    np.testing.assert_array_equal(h_last.numpy(), h0)
    jnp = ref.jax.numpy
    r_all, r_last = ref.ops.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(h0), use_kernel=True)
    np.testing.assert_allclose(np.asarray(r_all), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_last), h0, atol=1e-6)


@pytest.mark.parametrize("B,S,D", SHAPES + [
    (2, 1, 5),
    # shapes at the CUDA kernel's edges (S one step past its 32-step
    # tile, one short of it, one past three; D = 33 past its 32-channel
    # tile); the loop has no tiles, so only chip_smoke.py's kernel phase
    # holds the kernel itself at such edges
    (2, 33, 33), (2, 31, 33), (1, 97, 33)])
def test_plain_is_the_kernels_order_bit_for_bit(B, S, D):
    a, b, h0 = _inputs(B, S, D, seed=1)
    want_all, want_last = _numpy_loop(a, b, h0)
    got_all, got_last = kref.linear_scan_ref(*map(torch.from_numpy,
                                                  (a, b, h0)))
    np.testing.assert_array_equal(got_all.numpy(), want_all)
    np.testing.assert_array_equal(got_last.numpy(), want_last)


def test_ops_routes_agree_and_cpu_counts_no_launch():
    """On CPU tensors the wrapper takes the plain version (no launch
    counted); ``use_kernel`` True and False give the same bits, and the
    caller makes strided inputs contiguous."""
    a, b, h0 = map(torch.from_numpy, _inputs(2, 300, 200, seed=2))
    kernels.reset_launch_counts()
    k_all, k_last = ops.linear_scan(a, b, h0, use_kernel=True)
    p_all, p_last = ops.linear_scan(a, b, h0, use_kernel=False)
    assert torch.equal(k_all, p_all) and torch.equal(k_last, p_last)
    s_all, s_last = ops.linear_scan(a.transpose(0, 1).contiguous()
                                    .transpose(0, 1), b, h0)
    assert torch.equal(s_all, p_all) and torch.equal(s_last, p_last)
    assert kernels.launch_counts()["linear_scan"] == 0


def test_wrapper_checks_its_inputs():
    a, b, h0 = map(torch.from_numpy, _inputs(2, 8, 6, seed=3))
    with pytest.raises(TypeError):
        kernels.linear_scan(a.double(), b.double(), h0.double())
    with pytest.raises(ValueError):
        kernels.linear_scan(a[:, :0], b[:, :0], h0)           # S = 0
    with pytest.raises(ValueError):
        kernels.linear_scan(a, b[:, :4], h0)
    with pytest.raises(ValueError):
        kernels.linear_scan(a, b, h0[:, :5])
    with pytest.raises(ValueError):
        kernels.linear_scan(a[0], b[0], h0[0])                # not (B, S, D)
    with pytest.raises(ValueError):
        kernels.linear_scan(a.transpose(0, 1).contiguous().transpose(0, 1),
                            b, h0)                            # strided
    with pytest.raises(ValueError):                          # two devices
        kernels.linear_scan(a.to("meta"), b, h0)
    h_all, h_last = kernels.linear_scan(a.to("meta"), b.to("meta"),
                                        h0.to("meta"))       # reckoned
    assert (h_all.shape, h_last.shape, h_all.device.type) == \
        (a.shape, h0.shape, "meta")


def test_kernel_is_registered_and_built_from_its_source():
    """The CUDA source is one of the build's sources (compiled with nvcc
    for sm_90a at first use on the card), and the wrapper counts its
    launches with the others."""
    assert "linear_scan" in build.SOURCES
    src, so = build._target("linear_scan")
    assert src.is_file() and so.name.startswith("liblinear_scan-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert kernels.linear_scan in kernels.KERNELS
    assert "linear_scan" in kernels.launch_counts()
    text = src.read_text()
    assert "__fmul_rn" in text and "__fadd_rn" in text
    assert "linear_scan.py linear_scan_fsl" in text.replace("\n//", "")
