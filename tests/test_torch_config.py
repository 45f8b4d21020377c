"""The port's own configuration module against the JAX package's: the same
constants, the same dataclass fields in the same order with the same
defaults, the same presets and the same validation.  All comparisons are
exact."""

import dataclasses

import pytest

from tyrant_tpu import config as jcfg
from tyrant_tpu_torch import config as tcfg

_CLASSES = ["RenderConfig", "SkyConfig", "BVHConfig"]


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


def _defaults(obj):
    return {f.name: (dataclasses.asdict(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", _CLASSES)
def test_fields_order_and_defaults(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(t) == _fields(j)
    assert _defaults(t()) == _defaults(j())
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen


def test_constants():
    for name in ("PI", "INV_PI", "EPSILON", "VERY_FAR"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("preset", ["small_config", "interactive_config"])
def test_presets(preset):
    for kw in ({}, dict(width=64, height=48, num_rays=4096)):
        t = getattr(tcfg, preset)(**kw)
        j = getattr(jcfg, preset)(**kw)
        assert _defaults(t) == _defaults(j)
        assert t.num_pixels == j.num_pixels


@pytest.mark.parametrize("field,value", [
    ("packet_kernel_mode", "bogus"), ("tonemap", "filmic"),
    ("denoise", "maybe"), ("seed", -1), ("fog_g", 1.0),
    ("dispersion", 0.9), ("bokeh_blades", 2), ("motion_blur", 2.0),
    ("adaptive_connect_frac", 1.5), ("adaptive_interval", 0)])
def test_invalid_values_raise_in_both(field, value):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.RenderConfig(**{field: value})


def test_wave_spellings_accepted():
    for mode in ("auto", "mono", "wave", "wave-unsafe"):
        assert tcfg.RenderConfig(packet_kernel_mode=mode).packet_kernel_mode \
            == jcfg.RenderConfig(packet_kernel_mode=mode).packet_kernel_mode
