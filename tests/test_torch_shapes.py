"""The port's input shapes (``repro_torch.launch.shapes``) and the config
properties they read (``ModelConfig.is_decoder_only``,
``supports_long_decode``) against the reference's
(``repro.launch.shapes``, ``repro.models.common``), for every registered
arch and shape: host data, compared for equality."""
import dataclasses

import pytest

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shapes as S

pytestmark = pytest.mark.usefixtures("one_thread")


def _fields(cfg) -> dict:
    """A config's fields but its dtype (torch against jnp)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


def test_shapes_equal_field_by_field(ref):
    theirs = ref.shapes.SHAPES
    assert list(S.SHAPES) == list(theirs)
    assert S.SHAPE_IDS == ref.shapes.SHAPE_IDS
    assert S.LONG_WINDOW == ref.shapes.LONG_WINDOW
    for name, shape in S.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(theirs[name])
    assert S.SHAPES["prefill_32k"].seq_len == 32768


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_properties_equal(ref, arch):
    mine, theirs = get_config(arch), ref.configs.get_config(arch)
    for cfg_m, cfg_r in ((mine, theirs),
                         (mine.scaled_down(), theirs.scaled_down())):
        assert cfg_m.is_decoder_only == cfg_r.is_decoder_only
        assert cfg_m.supports_long_decode == cfg_r.supports_long_decode


@pytest.mark.parametrize("shape", list(S.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicability_and_variants_equal(ref, arch, shape):
    """``applicable`` (the skip reason word for word), ``config_for`` and
    ``long_context_variant`` give the reference's answers."""
    mine, theirs = get_config(arch), ref.configs.get_config(arch)
    s_m, s_r = S.SHAPES[shape], ref.shapes.SHAPES[shape]
    assert S.applicable(mine, s_m) == ref.shapes.applicable(theirs, s_r)
    assert _fields(S.config_for(mine, s_m)) == \
        _fields(ref.shapes.config_for(theirs, s_r))
    variant = S.long_context_variant(mine)
    assert _fields(variant) == \
        _fields(ref.shapes.long_context_variant(theirs))
    assert variant.dtype == mine.dtype
    assert variant.supports_long_decode
