"""Port config parity: the PyTorch port mirrors the JAX ``RenderConfig``
and its enums field for field, less the TPU kernel's scheduling fields."""
import dataclasses

import pytest

from raytracingpbr_tpu import config as jcfg
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu_torch import config as tcfg
from raytracingpbr_tpu_torch.convert import config_from_jax
from raytracingpbr_tpu_torch.models import cornell as tcornell

from . import torch_helpers  # noqa: F401  (caps torch threads)


# the JAX config's TPU kernel unroll, tile height and phase schedule,
# which the port has no use for and does not carry
JAX_SCHEDULING = ("march_chunk", "march_tile_rows", "march_phases")


def _as_plain(cfg):
    """Field dict with enums as their values (comparable across
    packages), less the JAX config's scheduling fields."""
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name in JAX_SCHEDULING:
            continue
        v = getattr(cfg, f.name)
        out[f.name] = v.value if hasattr(v, "value") else v
    return out


def test_fields_and_defaults_match():
    j = [(f.name, f.default) for f in dataclasses.fields(jcfg.RenderConfig)
         if f.name not in JAX_SCHEDULING]
    t = [(f.name, f.default) for f in dataclasses.fields(tcfg.RenderConfig)]
    assert [n for n, _ in t] == [n for n, _ in j]
    assert not set(JAX_SCHEDULING) & {n for n, _ in t}
    assert _as_plain(tcfg.RenderConfig()) == _as_plain(jcfg.RenderConfig())


@pytest.mark.parametrize("field,value", [("march_chunk", 64),
                                         ("march_tile_rows", 8),
                                         ("march_phases", (256, 256))])
def test_jax_scheduling_fields_are_dropped(field, value):
    """A JAX config that sets a scheduling field converts to the port's
    config of the same JAX config without it."""
    base = jcornell.minimal_config().replace(max_raymarch=512)
    got = config_from_jax(base.replace(**{field: value}))
    assert got == config_from_jax(base)
    assert not hasattr(got, field)


@pytest.mark.parametrize("name", ["Tonemap", "OmegaPolicy", "HitCriterion",
                                  "Roulette"])
def test_enum_values_match(name):
    j = {e.name: e.value for e in getattr(jcfg, name)}
    t = {e.name: e.value for e in getattr(tcfg, name)}
    assert t == j


@pytest.mark.parametrize("maker", ["full_config", "minimal_config",
                                   "v2_config", "v3_config"])
def test_cornell_configs_and_properties_match(maker):
    j = getattr(jcornell, maker)().replace(resolution=(64, 48))
    t = getattr(tcornell, maker)().replace(resolution=(64, 48))
    assert _as_plain(t) == _as_plain(j)
    for prop in ("width", "height", "num_pixels", "screen_pixel_size",
                 "pixel_radius", "min_dis"):
        assert getattr(t, prop) == getattr(j, prop)
    # the converter carries a JAX config across unchanged
    assert config_from_jax(j) == t
