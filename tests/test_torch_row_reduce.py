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
    port adds in the kernel's fixed order (8 chunks a row, 256 threads a
    chunk over 16-byte vectors with one accumulator a lane, the lanes in
    order, a halving tree, the chunks in rank order), the reference in its
    own; the largest gap seen is printed in ulps.

The port's order itself is written out one scalar at a time below and
the plain version held to it bit for bit.
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


ORDER_TYPES = {"f64": (np.float64, torch.float64, np.float64),
               "f32": (np.float32, torch.float32, np.float32),
               "bf16-f32": (np.float32, torch.bfloat16, np.float32)}


def _kernel_order(g: np.ndarray, acc, vec: int) -> np.ndarray:
    """The kernel's summation order written out one scalar at a time: 8
    chunks of ``reduce_chunk(d, vec)`` entries; in a chunk, entry e is lane
    e % vec of vector e // vec, which thread (e // vec) % 256 adds into its
    accumulator for that lane; lanes in order, the halving tree, chunks in
    rank order."""
    C, T = plain.REDUCE_CLUSTER, plain.REDUCE_THREADS
    out = []
    for row in g.astype(acc):
        d = len(row)
        L = plain.reduce_chunk(d, vec)
        chunks = []
        for c in range(C):
            lanes = [[acc(0)] * vec for _ in range(T)]
            for i in range(c * L, min((c + 1) * L, d)):
                v, k = divmod(i - c * L, vec)
                t = v % T
                lanes[t][k] = acc(lanes[t][k] + acc(row[i] * row[i]))
            part = []
            for t in range(T):
                p = lanes[t][0]
                for k in range(1, vec):
                    p = acc(p + lanes[t][k])
                part.append(p)
            s = T // 2
            while s:
                part = [acc(part[j] + part[j + s]) for j in range(s)]
                s //= 2
            chunks.append(part[0])
        total = chunks[0]
        for c in range(1, C):
            total = acc(total + chunks[c])
        out.append(total)
    return np.array(out, dtype=acc)


def _order_rows(kind, d, rows=3):
    npdt, tdt, _ = ORDER_TYPES[kind]
    g = torch.from_numpy(
        (np.random.default_rng(d).normal(size=(rows, d)) * 7).astype(npdt))
    return g.to(tdt)


def _vec(tdt) -> int:
    return 16 // torch.empty(0, dtype=tdt).element_size()


@pytest.mark.parametrize("kind", list(ORDER_TYPES))
@pytest.mark.parametrize("d", [1, 7, 15, 255, 256, 257, 1001, "CL-1",
                               "CL+1", 7851, 70001])
def test_plain_version_adds_in_the_kernel_order(kind, d):
    """d < C V (1, 7, 15), either side of a row that fills its 8 chunks
    (C L - 1 and + 1, L = 125 V), rows whose bytes are not a multiple of
    16 (7851, 70001: the kernel loads them entry by entry, in the same
    order), and the old design's block edges."""
    _, tdt, acc = ORDER_TYPES[kind]
    vec = _vec(tdt)
    if isinstance(d, str):
        d = plain.REDUCE_CLUSTER * 125 * vec + int(d[2:])
    g = _order_rows(kind, d)
    mx, ss = ops.row_maxabs_sumsq(
        g, acc_dtype=torch.float32 if kind == "bf16-f32" else None)
    np.testing.assert_array_equal(
        ss.numpy(), _kernel_order(g.to(mx.dtype).numpy(), acc, vec))
    np.testing.assert_array_equal(mx.numpy(),
                                  g.to(mx.dtype).abs().amax(1).numpy())


@pytest.mark.parametrize("kind", list(ORDER_TYPES))
def test_plain_version_nan_row(kind):
    """A NaN entry makes its row's maximum and sum NaN, and leaves the
    other rows as they were."""
    _, tdt, acc = ORDER_TYPES[kind]
    g = _order_rows(kind, 1001)
    g[1, 600] = float("nan")
    acc_dt = torch.float32 if kind == "bf16-f32" else None
    mx, ss = ops.row_maxabs_sumsq(g, acc_dtype=acc_dt)
    assert torch.isnan(mx[1]) and torch.isnan(ss[1])
    keep = [0, 2]
    np.testing.assert_array_equal(
        ss[keep].numpy(),
        _kernel_order(g[keep].to(mx.dtype).numpy(), acc, _vec(tdt)))


def test_plain_version_rows_past_grid_y_limit():
    """70,000 rows (past 65,535, the grid's y limit, which the kernel does
    not use): each row as on its own, and as the scalar order writer."""
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(70000, 13)).astype(np.float32))
    out = plain.row_maxabs_sumsq_ref(g, torch.float32)
    assert out.shape == (70000, 2)
    for r in (0, 65535, 65536, 69999):
        assert torch.equal(out[r], plain.row_maxabs_sumsq_ref(
            g[r:r + 1], torch.float32)[0])
    rows = [0, 65536, 69999]
    np.testing.assert_array_equal(out[rows, 1].numpy(),
                                  _kernel_order(g[rows].numpy(),
                                                np.float32, 4))


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
    with pytest.raises(ValueError):            # a meta g is checked too
        row_maxabs_sumsq(torch.zeros(8, 3, device="meta").t())
    out = row_maxabs_sumsq(torch.zeros(3, 8, device="meta"))   # reckoned
    assert (out.shape, out.device.type) == ((3, 2), "meta")
    launches = row_maxabs_sumsq.launches
    row_maxabs_sumsq(g)                    # the CPU takes the plain version
    assert row_maxabs_sumsq.launches == launches
