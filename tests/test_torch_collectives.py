"""The FL-LM collective's pieces against the JAX reference: the threefry
``split`` and ``normal`` and the chunked ``uniform``
(``repro_torch.core.rngstream``), the whole-tensor quantizer and the
key-driven OTA epilogue (``repro_torch.kernels.ops``), and
``wireless_psum`` (``repro_torch.core.collectives``) against
``repro.core.collectives.wireless_psum`` under ``shard_map``: one client
in this process, four clients in a subprocess with four JAX CPU devices.

Tolerances:
  * split, fold_in, uniform (chunked or not), the normal's uniforms, the
    quantizer's dither and codes: bit-equal;
  * normal: within 3 ulp (the port evaluates XLA's erfinv polynomial, but
    XLA's log1p and FMA contraction differ from torch's; 4.7% of entries
    differ at all);
  * quantizer outputs: bit-equal against the reference's plain version;
    within 1 ulp of m against its Pallas kernel in interpret mode (which
    contracts -m + safe*q into an FMA), codes bit-equal;
  * OTA epilogue: 4 ulp of |g*inv| + |z| (1 ulp of the reference's own
    slack plus the normals' 3 ulp);
  * wireless_psum, digital, client by client: dither, m and codes
    bit-equal; the payload floats w_m Q(g_m) within 2 ulp of m |w_m|
    (under ``jit`` XLA contracts the reference's -m + safe*q into an FMA,
    in its plain version and its interpret-mode kernel alike: 1 ulp of m;
    then each side rounds its own product by w_m);
  * wireless_psum, the client sums: within ``SUM_ULPS`` ulp of the sum of
    the terms' magnitudes (XLA's psum over four CPU devices need not add
    in client order; ``pytest -s`` prints the gap it showed), plus the
    payloads' 1 ulp of m |w_m| each (digital) or the normals' 4 ulp
    (OTA).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.core import rngstream
from repro_torch.core.collectives import WirelessRound, wireless_psum
from repro_torch.kernels import dithered_quantize, ops, ref as kref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_ULPS = 2.0

# The reference's wireless_psum under shard_map over n clients on the
# "data" axis, on fed per-client leaves: the client sums of each mode and
# (skip_psum) each client's own digital payload, plain and interpret mode.
REF_SRC = textwrap.dedent('''
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_auto_mesh, shard_map
    from repro.core.collectives import WirelessRound, wireless_psum


    def run(inp, mode, use_kernel, per_client):
        n = int(inp["n"])
        mesh = make_auto_mesh((n,), ("data",))
        names = sorted(k[2:] for k in inp if k.startswith("g/"))

        def body(g, w, lv, key):
            r = WirelessRound(weight=w, alpha=jnp.float32(inp["alpha"]),
                              noise_scale=jnp.float32(inp["noise_scale"]),
                              levels=lv)
            g = {k: v[0] for k, v in g.items()}
            out = wireless_psum(g, r, ("data",), key, mode=mode,
                                use_kernel=use_kernel,
                                skip_psum={k: per_client for k in g})
            return {k: v[None] for k, v in out.items()} if per_client else out

        spec = P("data") if per_client else P()
        f = shard_map(body, mesh, in_specs=(P("data"),) * 3 + (P(),),
                      out_specs=spec, manual_axes=("data",))
        g = {k: jnp.asarray(inp["g/" + k]) for k in names}
        out = jax.jit(f)(g, jnp.asarray(inp["weight"]),
                         jnp.asarray(inp["levels"]),
                         jax.random.key(int(inp["seed"])))
        return {k: np.asarray(v) for k, v in out.items()}


    def run_all(inp):
        out = {}
        for mode in ("ideal", "ota", "digital"):
            for k, v in run(inp, mode, False, False).items():
                out[f"{mode}/{k}"] = v
        for uk in (False, True):
            for k, v in run(inp, "digital", uk, True).items():
                out[f"client{int(uk)}/{k}"] = v
        return out


    if __name__ == "__main__":
        import sys
        np.savez(sys.argv[2], **run_all(dict(np.load(sys.argv[1]))))
''')

LEAVES = {"embed": (96, 16), "final_norm": (16,),
          "groups.b0.mlp.w_gate": (3, 16, 40), "lm_head": (16, 96)}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _inputs(n, seed=0):
    rng = np.random.default_rng([n, seed])
    inp = {"n": n, "alpha": np.float32(2.5), "noise_scale": np.float32(1e-2),
           "seed": 11,
           "weight": np.array([0.5, 0.0, 1.5, 1.0][:n], np.float32),
           "levels": np.array([255.0, 15.0, 0.0, 1023.0][:n], np.float32)}
    if n == 1:
        inp["weight"] = np.array([1.5], np.float32)
    for name, shape in LEAVES.items():
        g = rng.standard_normal((n,) + shape) * rng.uniform(0.1, 5.0)
        inp["g/" + name] = g.astype(np.float32)
    inp["g/final_norm"][0] = 0.0          # a zero leaf: m = 0 gives exact 0
    return inp


def _clients(inp):
    names = sorted(LEAVES)
    return [[torch.from_numpy(inp["g/" + k][m]) for k in names]
            for m in range(int(inp["n"]))]


def _round(inp, weight=None):
    return WirelessRound(
        weight=torch.from_numpy(inp["weight"] if weight is None else weight),
        alpha=torch.tensor(inp["alpha"]),
        noise_scale=torch.tensor(inp["noise_scale"]),
        levels=torch.from_numpy(inp["levels"]))


def _assert_ulps(got, want, scale, ulps):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ulps * np.spacing(np.asarray(scale, np.float32))
    gap = np.abs(got - want)
    assert np.all(gap <= tol), float(np.max(gap / tol)) * ulps
    return float(np.max(gap / np.spacing(np.asarray(scale, np.float32))))


# --------------------------------------------------------------- streams

@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 - 1])
@pytest.mark.parametrize("n", [1, 2, 12, 33])
def test_split_bit_equal(ref, seed, n):
    jax = ref.jax
    want = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed), n)))
    got = rngstream.split(rngstream.prng_key(seed), n)
    assert [tuple(int(v) for v in row) for row in want] == got


@pytest.mark.parametrize("shape", [(7,), (3, 2049), (5, 7, 1001), (65537,)])
def test_chunked_uniform_bit_equal(ref, monkeypatch, shape):
    """Counters are flat indices, so hashing them 1000 at a time gives
    JAX's bits; so do the per-trial dither blocks (tensor keys)."""
    jax = ref.jax
    monkeypatch.setattr(rngstream, "UNIFORM_CHUNK", 1000)
    key = jax.random.fold_in(jax.random.key(3), 9)
    want = jax.random.uniform(key, shape, dtype=jax.numpy.float32)
    got = rngstream.uniform(rngstream.fold_in(rngstream.prng_key(3), 9),
                            shape)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    keys = [rngstream.dither_base_key(4, tr) for tr in range(3)]
    batch = rngstream.dither_blocks(keys, 2, 3, 777)
    for tr in range(3):
        np.testing.assert_array_equal(
            _bits(batch[tr].numpy()), _bits(ref.rngstream.dither_block(
                ref.rngstream.dither_base_key(4, tr), 2, 3, 777)))


@pytest.mark.parametrize("shape", [(7,), (3, 5, 1001), (1 << 18,)])
def test_normal_within_3ulp(ref, monkeypatch, shape):
    jax = ref.jax
    monkeypatch.setattr(rngstream, "UNIFORM_CHUNK", 5000)
    key = jax.random.split(jax.random.key(5), 4)[3]
    mine = rngstream.split(rngstream.prng_key(5), 4)[3]
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u_want = jax.random.uniform(key, shape, jax.numpy.float32, lo, 1.0)
    u_got = torch.clamp_min(rngstream.uniform(mine, shape) * 2.0
                            + rngstream._NORMAL_LO, rngstream._NORMAL_LO)
    np.testing.assert_array_equal(_bits(u_want), _bits(u_got.numpy()))
    want = np.asarray(jax.random.normal(key, shape, jax.numpy.float32))
    got = rngstream.normal(mine, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    gap = _assert_ulps(got, want, np.abs(want), 3.0)
    print(f"normal: max {gap} ulp, {np.mean(got != want):.4f} of entries "
          f"differ")


# ------------------------------------------------------ kernel 3's callers

CASES = [((3, 16, 40), 255.0), ((1001,), 15.0), ((2, 3, 5), 1023.0),
         ((64,), 0.0), ((4, 4), -1.0)]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("shape,levels", CASES)
def test_dithered_quantize_matches_reference(ref, dt, shape, levels):
    """Against ``repro.kernels.ops.dithered_quantize``: its plain version
    bit for bit; its Pallas kernel (interpret mode) with codes bit-equal
    and outputs within 1 ulp of m. levels <= 0 and an all-zero tensor give
    exactly 0."""
    jax, jnp = ref.jax, ref.jax.numpy
    npdt, tdt = (np.float32, torch.float32) if dt == "f32" else (
        np.float64, torch.float64)
    rng = np.random.default_rng(len(shape))
    for g in ((rng.standard_normal(shape) * 3).astype(npdt),
              np.zeros(shape, npdt)):
        key = jax.random.split(jax.random.key(8), 3)[1]
        mine = rngstream.split(rngstream.prng_key(8), 3)[1]
        with jax.enable_x64(dt == "f64"):
            want = {uk: np.asarray(ref.ops.dithered_quantize(
                jnp.asarray(g), jnp.asarray(levels, npdt), key,
                use_kernel=uk)) for uk in (False, True)}
        for use_kernel in (False, True):     # the wrapper on the CPU is plain
            got = ops.dithered_quantize(torch.from_numpy(g), levels, mine,
                                        use_kernel=use_kernel).numpy()
            assert got.dtype == npdt and got.shape == shape
            np.testing.assert_array_equal(_bits(got), _bits(want[False]))
        m = np.max(np.abs(g))
        if levels <= 0 or m == 0:
            assert not np.any(got) and not np.any(want[True])
            continue
        safe = 2.0 * m / levels
        codes = lambda out: np.round((out.astype(np.float64) + m) / safe)
        np.testing.assert_array_equal(codes(got), codes(want[True]))
        _assert_ulps(got, want[True], m, 1.0)


@pytest.mark.parametrize("shape", [(3, 16, 40), (1001,)])
def test_ota_combine_key_form_within_4ulp(ref, shape):
    """``ops.ota_combine(g, alpha, noise_scale, key)``: z = noise_scale *
    normal(key), not scaled by 1/alpha again, then g*inv_alpha + z."""
    jax, jnp = ref.jax, ref.jax.numpy
    g = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    key = jax.random.split(jax.random.key(2), 5)[4]
    mine = rngstream.split(rngstream.prng_key(2), 5)[4]
    want = np.asarray(ref.ops.ota_combine(jnp.asarray(g), jnp.float32(2.5),
                                          jnp.float32(0.3), key))
    z = 0.3 * np.asarray(jax.random.normal(key, shape, jnp.float32))
    for use_kernel in (False, True):
        got = ops.ota_combine(torch.from_numpy(g), 2.5, 0.3, mine,
                              use_kernel=use_kernel)
        _assert_ulps(got.numpy(), want, np.abs(g * np.float32(0.4))
                     + np.abs(z), 4.0)


def test_whole_tensor_wrapper_is_the_plain_version_and_checks():
    g = torch.randn(3, 5, 7, dtype=torch.float64)
    u = torch.rand(3, 5, 7)
    scal = torch.stack([g.abs().amax(), torch.tensor(63.0, dtype=g.dtype)])
    out = dithered_quantize(g, u, scal)
    assert torch.equal(out, kref.dithered_quantize_ref(g, u, scal[0],
                                                       scal[1]))
    assert torch.equal(out, kref.dithered_quantize_rows_ref(
        g.reshape(1, -1), u.reshape(1, -1), scal[:1], scal[1:]).reshape(
        g.shape))
    with pytest.raises(TypeError):
        dithered_quantize(g.float(), u, scal)
    with pytest.raises(TypeError):
        dithered_quantize(g, u.double(), scal)
    with pytest.raises(ValueError):
        dithered_quantize(g, u[:2], scal)
    with pytest.raises(ValueError):
        dithered_quantize(g, u, scal[None])
    with pytest.raises(ValueError):            # operands on two devices
        dithered_quantize(g.to("meta"), u, scal)
    # on the meta device the call is reckoned: the plain version's shape
    # and dtype, no data, no launch
    out = dithered_quantize(g.to("meta"), u.to("meta"), scal.to("meta"))
    assert (out.shape, out.dtype, out.device.type) == (g.shape, g.dtype,
                                                        "meta")


# ---------------------------------------------------------- wireless_psum

def _codes(out, m, w, levels):
    """Quantizer codes q of a payload out = w * (-m + (2m/L) q)."""
    safe = 2.0 * m / levels
    return np.round((out.astype(np.float64) / w + m) / safe)


def _check_psum(inp, want):
    """The port's three modes against the reference's outputs ``want``."""
    names = sorted(LEAVES)
    n = int(inp["n"])
    key = rngstream.prng_key(int(inp["seed"]))
    clients = _clients(inp)
    w = inp["weight"].astype(np.float64)
    inv_alpha = 1.0 / float(inp["alpha"])
    worst = {}
    for mode in ("ideal", "ota", "digital"):
        got = wireless_psum(iter(clients), _round(inp), key, mode=mode,
                            use_kernel=False)
        assert [g.dtype for g in got] == [torch.float32] * len(names)
        for j, k in enumerate(names):
            g = inp["g/" + k].astype(np.float64)
            ms = np.abs(g).reshape(n, -1).max(axis=1)
            if mode == "ideal":
                scale, slack = np.sum(np.abs(g), axis=0) / n, 0.0
            elif mode == "ota":
                scale = (np.tensordot(np.abs(w), np.abs(g), axes=1)
                         * inv_alpha + np.abs(want[f"ota/{k}"]))
                slack = 4.0 * np.spacing(scale.astype(np.float32))
            else:
                q = want[f"client0/{k}"].astype(np.float64)
                scale = np.sum(np.abs(q), axis=0)
                slack = np.sum(np.spacing((ms * np.abs(w)).astype(
                    np.float32)))
            gap = np.abs(got[j].numpy().astype(np.float64)
                         - want[f"{mode}/{k}"])
            tol = SUM_ULPS * np.spacing(scale.astype(np.float32)) + slack
            assert np.all(gap <= tol), (mode, k, float(np.max(gap / tol)))
            worst[mode] = max(worst.get(mode, (0.0, 0.0))[0],
                              float(np.max(gap / tol))), max(
                worst.get(mode, (0.0, 0.0))[1],
                float(np.max(gap / np.spacing(scale.astype(np.float32)))))
    # digital, client by client: zeroing the other clients' weights makes
    # the sum client m's own payload w_m Q(g_m). Its dither, m and codes
    # must be the reference's bit for bit; the floats are within 2 ulp of
    # m |w_m|: the jitted reference contracts -m + safe*q (in its plain
    # version and its interpret-mode kernel) into an FMA, 1 ulp of m, and
    # each side then rounds its own product by w_m.
    for m in range(n):
        if w[m] == 0:
            continue
        alone = np.zeros(n, np.float32)
        alone[m] = inp["weight"][m]
        got = wireless_psum(iter(clients), _round(inp, alone), key,
                            mode="digital", use_kernel=False)
        lv = float(inp["levels"][m])
        for j, k in enumerate(names):
            mine = got[j].numpy()
            mk = float(np.max(np.abs(inp["g/" + k][m])))
            for route in ("client0", "client1"):
                theirs = want[f"{route}/{k}"][m]
                if lv <= 0 or mk == 0:
                    assert not np.any(mine) and not np.any(theirs)
                    continue
                np.testing.assert_array_equal(
                    _codes(mine, mk, w[m], lv), _codes(theirs, mk, w[m], lv))
                _assert_ulps(mine, theirs, mk * abs(w[m]), 2.0)
    print(f"wireless_psum over {n} clients: worst gap as a share of its "
          f"tolerance, and in ulp of the sum of the terms' magnitudes, by "
          f"mode: {worst}")


def test_wireless_psum_one_client_matches_reference(ref):
    ns = {}
    exec(REF_SRC, ns)
    inp = _inputs(1)
    _check_psum(inp, ns["run_all"](inp))


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference's outputs over 4 clients on 4 JAX CPU devices (a
    subprocess: the device count is fixed when JAX starts)."""
    d = tmp_path_factory.mktemp("ref4")
    inp = _inputs(4)
    np.savez(d / "in.npz", **inp)
    (d / "ref4.py").write_text(REF_SRC)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, str(d / "ref4.py"),
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return inp, dict(np.load(d / "out.npz"))


def test_wireless_psum_four_clients_matches_reference(ref4):
    _check_psum(*ref4)


@pytest.mark.parametrize("mode", ["ideal", "ota", "digital"])
def test_wireless_psum_streams_and_casts_back(mode):
    """A generator of clients gives the list's result; leaves come back in
    their dtype (bf16 aggregated in f32); the inputs are not changed; OTA
    makes one epilogue launch a leaf, digital one quantizer launch a
    client and leaf (on the CPU the wrappers count none: they take the
    plain versions, which this checks give the same bits)."""
    inp = _inputs(4, seed=1)
    clients = _clients(inp)
    clients = [[g.to(torch.bfloat16) if j == 0 else g
                for j, g in enumerate(c)] for c in clients]
    before = [[g.clone() for g in c] for c in clients]
    key = rngstream.prng_key(3)
    a = wireless_psum(iter(clients), _round(inp), key, mode=mode)
    b = wireless_psum((c for c in clients), _round(inp), key, mode=mode,
                      use_kernel=False)
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for c, c0 in zip(clients, before)
               for x, y in zip(c, c0))
    with pytest.raises(ValueError):
        wireless_psum(iter(clients), _round(inp), key, mode="analog")
