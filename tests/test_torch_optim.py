"""The port's optimizers (``repro_torch.optim``: Adam and the l2-ball
projection) on the CPU against ``repro.optim`` in eager JAX (one XLA
computation an op, so nothing is fused or contracted).

Adam over 50 steps on f32 and bf16 parameters, with and without weight
decay: parameters, both f32 moments and the step bit for bit (the bias
corrections 1 - b ** step are f32 powers; the host's ``powf`` and XLA's
gave the same bits at every step checked, 1 to 200, for b = 0.9 and
0.999).

The projection inside and outside the ball, and on the whisper model's
parameters in the reference's leaf order. Its sums of squares are f32
reductions, which torch and XLA add in different orders, so the scale
is held within ``SCALE_ULPS`` = 16 ulps of the reference's formula on
the same inputs (up to 12 seen over 80 draws, up to 6 on the model) and
each projected parameter within 16 ulps of the reference's in f32 and
1 ulp in bf16 (up to 3 and 0 seen; ROADMAP Queue 3). Inside the ball
both return the parameters unchanged.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               project_l2_ball)

pytestmark = pytest.mark.usefixtures("one_thread")

SHAPES = [(9, 13), (40,), (3, 4, 5), (1,)]
DTYPES = {"f32": ("float32", torch.float32),
          "bf16": ("bfloat16", torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """A tensor's or an array's values widened to f32 (exact for bf16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _equal(port, want):
    for a, b in zip(port, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


SCALE_ULPS = 16


def _ulps(port, want) -> int:
    """The largest gap in units in the last place of the port tensor's
    dtype (f32 or bf16), as integers of its bits."""
    a = port.detach().float().numpy()
    b = np.asarray(want, np.float32)
    shift = 16 if port.dtype == torch.bfloat16 else 0
    ia = a.view(np.int32).astype(np.int64) >> shift
    ib = b.view(np.int32).astype(np.int64) >> shift
    return int(np.max(np.abs(ia - ib))) if ia.size else 0


def _ref_scale(jnp, leaves, radius):
    """``repro.optim.projection``'s scale, in its own ops."""
    sq = sum(jnp.sum(jnp.square(x.astype(jnp.float32))) for x in leaves)
    return jnp.minimum(1.0, radius / jnp.maximum(jnp.sqrt(sq), 1e-30))


def _projected_close(port, want, scale, want_scale):
    assert _ulps(scale, want_scale) <= SCALE_ULPS
    for a, b in zip(port, want):
        assert _ulps(a, b) <= (1 if a.dtype == torch.bfloat16
                               else SCALE_ULPS), (a.dtype, _ulps(a, b))


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_adam_matches_reference_for_50_steps(ref, dt, wd):
    jnp = ref.jax.numpy
    jdt, tdt = getattr(jnp, DTYPES[dt][0]), DTYPES[dt][1]
    adam = ref.adam
    rng = np.random.default_rng([len(dt), int(wd * 100)])
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    kw = dict(eta=1e-2, weight_decay=wd)
    rp = [jnp.asarray(a, jdt) for a in p0]
    rs = adam.adam_init(rp)
    tp = [torch.tensor(a).to(tdt) for a in p0]     # copies: updated in place
    ts = adam_init(tp)
    assert all(m.dtype == torch.float32 and not bool(m.any())
               for m in ts["m"] + ts["v"])
    for _ in range(50):
        g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        rp, rs = adam.adam_update(adam.AdamConfig(**kw), rp,
                                  [jnp.asarray(a, jdt) for a in g], rs)
        ts = adam_update(AdamConfig(**kw), tp,
                         [torch.from_numpy(a).to(tdt) for a in g], ts)
    assert all(p.dtype == tdt for p in tp)
    _equal(tp, rp)
    _equal(ts["m"], rs["m"])
    _equal(ts["v"], rs["v"])
    assert int(ts["step"]) == int(rs["step"]) == 50
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("radius", [1.0, 1e3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_projection_matches_reference(ref, dt, radius):
    """Outside the ball (radius 1: the norm is about 14) every entry is
    scaled; inside (1e3) the parameters come back as they were."""
    jnp = ref.jax.numpy
    jdt, tdt = getattr(jnp, DTYPES[dt][0]), DTYPES[dt][1]
    rng = np.random.default_rng([len(dt), int(radius)])
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    rp = [jnp.asarray(a, jdt) for a in p0]
    want = ref.projection.project_l2_ball(rp, radius)
    tp = [torch.tensor(a).to(tdt) for a in p0]     # copies: updated in place
    before = [p.clone() for p in tp]
    scale = project_l2_ball(tp, radius)
    assert scale.dtype == torch.float32
    _projected_close(tp, want, scale, _ref_scale(jnp, rp, radius))
    if radius > 100:
        _equal(tp, want)
        assert float(scale) == 1.0
        assert all(torch.equal(a, b) for a, b in zip(tp, before))
    else:
        assert float(scale) < 0.1


def test_projection_of_a_model_in_reference_leaf_order(ref):
    """Scaled-down whisper-tiny's parameters, passed in the reference's
    leaf order, project as the reference's parameter tree does, within
    the ulps above."""
    jax = ref.jax
    rmodel = ref.api.make_model(
        ref.configs.get_config("whisper-tiny").scaled_down())
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.key(2)))
    model = make_model(get_config("whisper-tiny").scaled_down(), seed=None,
                       device="cpu")
    model.load_state_dict(interop.model_state(params))
    want = ref.projection.project_l2_ball(params, 10.0)
    leaves = interop.reference_leaves(model)
    scale = project_l2_ball([p for leaf in leaves for p in leaf.params],
                            10.0)
    assert float(scale) < 0.1
    _projected_close([leaf.value() for leaf in leaves],
                     jax.tree.leaves(want), scale,
                     _ref_scale(jax.numpy, jax.tree.leaves(params), 10.0))
