"""The port's selective scan (``repro_torch.kernels.ops.selective_scan``) on
CPU tensors against ``repro.kernels.ref.selective_scan_ref`` and against
``repro.kernels.ops.selective_scan`` with its Pallas kernel in interpret
mode, on the same numpy-made inputs.

On the CPU the wrapper takes its plain version (``ref.
selective_scan_ref``); the CUDA kernel is held bit-equal to that on the
card by ``chip_smoke.py``. What is compared, and how closely:

  * against the reference: atol 3e-5 on y and h_last, the slack the
    reference's own kernel test allows (``tests/test_kernels.py``). The
    port rounds every product and sum on its own and adds y's n terms in
    order; the reference's oracle may contract a*h + b into an FMA and
    sums y in a dot product, its Pallas kernel runs a log-step scan;
  * the plain version against a scalar loop in the kernel's order (each
    op rounded to f32, y summed j = 0..n-1): bit-equal, with exp taken
    from torch in both (the kernel's expf is held to torch's exp on the
    card), also at shapes where the CUDA kernel's warps and tiles split
    unevenly (its tile edges themselves are checked on the card only);
  * the wrapper's checks: f32 only, contiguous, n <= 16, matching shapes.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch.kernels import ops, ref as plain, selective_scan

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 3e-5
# tests/test_kernels.py's shapes, plus ragged S and D with the largest n
SHAPES = [(1, 128, 128, 8), (2, 300, 200, 16), (2, 64, 100, 4),
          (1, 37, 129, 16)]


def _inputs(B, S, D, n, seed=7):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng([B, S, D, n, seed])
    f = np.float32
    return (rng.uniform(0.001, 0.2, (B, S, D)).astype(f),
            rng.normal(size=(B, S, D)).astype(f),
            (rng.normal(size=(B, S, n)) * 0.5).astype(f),
            (rng.normal(size=(B, S, n)) * 0.5).astype(f),
            (-np.exp(rng.normal(size=(D, n)) * 0.3)).astype(f),
            (rng.normal(size=(B, D, n)) * 0.1).astype(f))


def _port(ins, use_kernel=True):
    y, h = ops.selective_scan(*map(torch.from_numpy, ins),
                              use_kernel=use_kernel)
    assert y.dtype == h.dtype == torch.float32
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("route", ["ref-oracle", "ref-interpret"])
@pytest.mark.parametrize("B,S,D,n", SHAPES)
def test_matches_reference(ref, B, S, D, n, route):
    ins = _inputs(B, S, D, n)
    jnp = ref.jax.numpy
    args = [jnp.asarray(a) for a in ins]
    if route == "ref-oracle":
        y_r, h_r = ref.ref.selective_scan_ref(*args)
    else:
        y_r, h_r = ref.ops.selective_scan(*args, use_kernel=True)
    y_p, h_p = _port(ins)
    assert y_p.shape == (B, S, D) and h_p.shape == (B, D, n)
    np.testing.assert_allclose(y_p, np.asarray(y_r), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h_p, np.asarray(h_r), rtol=0, atol=ATOL)
    print(f"{route} {(B, S, D, n)}: y within "
          f"{np.max(np.abs(y_p - np.asarray(y_r))):.3g}, h_last within "
          f"{np.max(np.abs(h_p - np.asarray(h_r))):.3g}")


def _kernel_order(ins, exp_a):
    """The kernel's arithmetic, one channel at a time, in f32 scalars."""
    dt, x, bm, cm, _, h0 = ins
    B, S, D = dt.shape
    n = bm.shape[-1]
    f = np.float32
    y = np.empty_like(dt)
    h = h0.copy()
    for b in range(B):
        for d in range(D):
            for t in range(S):
                acc = f(0)
                for j in range(n):
                    db = f(f(dt[b, t, d] * bm[b, t, j]) * x[b, t, d])
                    h[b, d, j] = f(f(exp_a[b, t, d, j] * h[b, d, j]) + db)
                    p = f(h[b, d, j] * cm[b, t, j])
                    acc = p if j == 0 else f(acc + p)
                y[b, t, d] = acc
    return y, h


@pytest.mark.parametrize("B,S,D,n", [
    (2, 5, 3, 4), (1, 9, 2, 16),
    # shapes at the CUDA kernel's edges (n not divisible by its 4 warps,
    # D = 33 past its 32-lane tile, S one step past its 8-step tile and
    # past two); the loop has no tiles, so these pin the plain version's
    # order there, and only chip_smoke.py's kernel phase holds the kernel
    # itself at such edges
    (2, 6, 3, 1), (1, 5, 33, 5), (2, 4, 3, 13),
    (1, 9, 3, 16), (1, 17, 2, 13)])
def test_plain_version_is_the_kernels_order(B, S, D, n):
    ins = _inputs(B, S, D, n, seed=3)
    dt, a_w = torch.from_numpy(ins[0]), torch.from_numpy(ins[4])
    exp_a = torch.exp(dt[..., None] * a_w).numpy()
    y_k, h_k = _kernel_order(ins, exp_a)
    y_p, h_p = _port(ins)
    np.testing.assert_array_equal(y_p, y_k)
    np.testing.assert_array_equal(h_p, h_k)


def test_kernel_and_plain_routes_agree_on_cpu():
    """On CPU tensors the wrapper takes the plain version: the two routes
    of the caller are the same function, and neither counts a launch."""
    ins = _inputs(2, 130, 33, 16)
    before = selective_scan.launches
    y_k, h_k = _port(ins, use_kernel=True)
    y_p, h_p = _port(ins, use_kernel=False)
    np.testing.assert_array_equal(y_k, y_p)
    np.testing.assert_array_equal(h_k, h_p)
    assert selective_scan.launches == before


def test_chunking_of_the_plain_version_keeps_bits(monkeypatch):
    ins = [torch.from_numpy(a) for a in _inputs(1, 300, 16, 8)]
    whole = plain.selective_scan_ref(*ins)
    monkeypatch.setattr(plain, "SCAN_CHUNK", 7)
    chunked = plain.selective_scan_ref(*ins)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_zero_dt_keeps_the_state():
    """dt = 0: exp(0) = 1 and no input, so h stays h0 and y_t = h0 @ C_t."""
    dt, x, bm, cm, a_w, h0 = _inputs(2, 11, 9, 4)
    dt = np.zeros_like(dt)
    y, h = _port((dt, x, bm, cm, a_w, h0))
    np.testing.assert_array_equal(h, h0)
    np.testing.assert_allclose(y, np.einsum("bdn,bsn->bsd", h0, cm),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", ["n17", "f64", "bf16", "noncontig",
                                 "shape", "meta"])
def test_wrapper_rejects(bad):
    ins = [torch.from_numpy(a) for a in _inputs(1, 4, 8, 4)]
    if bad == "n17":
        dt, x = ins[0], ins[1]
        ins = [dt, x, torch.zeros(1, 4, 17), torch.zeros(1, 4, 17),
               torch.zeros(8, 17), torch.zeros(1, 8, 17)]
        err = ValueError
    elif bad in ("f64", "bf16"):
        ins[1] = ins[1].to(torch.float64 if bad == "f64" else torch.bfloat16)
        err = TypeError
    elif bad == "noncontig":
        ins[0] = ins[0].transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    elif bad == "shape":
        ins[4] = ins[4][:-1]
        err = ValueError
    else:                # meta inputs are reckoned, but not beside CPU ones
        ins = [t.to("meta") for t in ins[:3]] + ins[3:]
        err = ValueError
    with pytest.raises(err):
        selective_scan(*ins)
