"""The port's per-row statistics (``repro_torch.kernels.ops.
row_maxabs_sumsq``) on CPU tensors against ``repro.kernels.ops.
row_maxabs_sumsq``, with its Pallas kernel in interpret mode and with its
plain jnp path, on the same numpy-made rows.

On the CPU the wrapper takes its plain version (``ref.
row_maxabs_sumsq_ref``); the CUDA kernel is held bit-equal to that on the
card by ``chip_smoke.py``. What is compared, and how closely:

  * maxabs: bit-equal (a maximum does not depend on order);
  * sumsq: a sum of nonnegative terms, which any two orders give within
    (d - 1) eps sum g^2 of each other (eps of the accumulator type). The
    port adds in the kernel's fixed order (256 strided partial sums, then
    a halving tree), the reference in its own; the largest gap seen is
    printed in ulps.
"""
import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.kernels import ops, ref as plain, row_maxabs_sumsq

DIMS = (1, 7, 650, 7850, 70001)
TYPES = {"f64": (np.float64, torch.float64, None),
         "f32": (np.float32, torch.float32, None),
         "bf16-f32": (np.float32, torch.bfloat16, torch.float32)}
N_ROWS = 5


def _rows(ref, d, kind):
    """Rows of mixed scale; row 1 all zero, row 2 with its largest entry
    negative. bf16 rows are made in bf16 and held as their exact f32
    values."""
    rng = np.random.default_rng([d, len(kind)])
    g = rng.normal(size=(N_ROWS, d)) * rng.uniform(0.01, 50.0,
                                                   size=(N_ROWS, 1))
    g[1] = 0.0
    g[2] = np.clip(g[2], -50.0, 50.0)
    g[2, d // 2] = -100.0
    if kind == "bf16-f32":
        jnp = ref.jax.numpy
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return g.astype(TYPES[kind][0])


def _port(g, kind):
    _, tdt, acc = TYPES[kind]
    return ops.row_maxabs_sumsq(torch.from_numpy(g).to(tdt), acc_dtype=acc)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["ref-interpret", "ref-plain"])
@pytest.mark.parametrize("kind", list(TYPES))
@pytest.mark.parametrize("d", DIMS)
def test_matches_reference(ref, d, kind, use_kernel):
    g = _rows(ref, d, kind)
    jnp = ref.jax.numpy
    acc = np.float64 if kind == "f64" else np.float32
    with ref.jax.enable_x64(kind == "f64"):
        gj = jnp.asarray(g, jnp.bfloat16 if kind == "bf16-f32" else g.dtype)
        mx_r, ss_r = ref.ops.row_maxabs_sumsq(
            gj, use_kernel=use_kernel,
            acc_dtype=jnp.float32 if kind == "bf16-f32" else None)
        mx_r, ss_r = np.asarray(mx_r), np.asarray(ss_r)
    mx_p, ss_p = _port(g, kind)
    assert mx_p.dtype == ss_p.dtype == {np.float64: torch.float64,
                                        np.float32: torch.float32}[acc]
    np.testing.assert_array_equal(mx_p.numpy(), mx_r)
    assert mx_p[1] == 0 and mx_p[2] == 100.0
    total = np.sum(g.astype(np.float64) ** 2, axis=1)
    eps = np.finfo(acc).eps
    gap = np.abs(ss_p.numpy().astype(np.float64) - ss_r)
    assert np.all(gap <= (d - 1) * eps * total), (gap, total)
    assert ss_p[1] == 0
    print(f"d={d} {kind}: sumsq within "
          f"{np.max(gap / np.spacing(ss_r.astype(acc)))} ulp")


def _kernel_order(g: np.ndarray, acc) -> np.ndarray:
    """The kernel's summation order written out one scalar at a time."""
    out = []
    for row in g.astype(acc):
        part = [acc(0)] * plain.REDUCE_THREADS
        for i, x in enumerate(row):
            j = i % plain.REDUCE_THREADS
            part[j] = acc(part[j] + acc(x * x))
        s = plain.REDUCE_THREADS // 2
        while s:
            part = [acc(part[j] + part[j + s]) for j in range(s)]
            s //= 2
        out.append(part[0])
    return np.array(out, dtype=acc)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("d", [1, 255, 256, 257, 1001])
def test_plain_version_adds_in_the_kernel_order(dt, d):
    g = np.random.default_rng(d).normal(size=(3, d)).astype(dt) * 7
    _, ss = ops.row_maxabs_sumsq(torch.from_numpy(g))
    np.testing.assert_array_equal(ss.numpy(), _kernel_order(g, dt))


def test_leading_dimensions_and_plain_route():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 4, 300)))
    mx, ss = ops.row_maxabs_sumsq(g)
    assert mx.shape == ss.shape == (3, 4)
    mx2, ss2 = ops.row_maxabs_sumsq(g, use_kernel=False)
    assert torch.equal(mx, mx2) and torch.equal(ss, ss2)
    assert torch.equal(mx, g.abs().amax(-1))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(3, 8)
    with pytest.raises(TypeError):
        row_maxabs_sumsq(g, torch.float64)              # f32 -> f64
    with pytest.raises(TypeError):
        row_maxabs_sumsq(g.to(torch.float16))
    with pytest.raises(TypeError):
        row_maxabs_sumsq(g.to(torch.bfloat16))          # bf16 needs f32 acc
    with pytest.raises(ValueError):
        row_maxabs_sumsq(torch.zeros(8))
    with pytest.raises(ValueError):
        row_maxabs_sumsq(torch.zeros(3, 0))
    with pytest.raises(ValueError):
        row_maxabs_sumsq(torch.zeros(3, 8, device="meta"))
    launches = row_maxabs_sumsq.launches
    row_maxabs_sumsq(g)                    # the CPU takes the plain version
    assert row_maxabs_sumsq.launches == launches
