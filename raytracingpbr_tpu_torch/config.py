"""Render configuration.

Mirror of ``raytracingpbr_tpu/config.py``: the same enums (same values) and
the same frozen ``RenderConfig`` fields, defaults and properties, so a JAX
config converts field by field (``convert.config_from_jax``). The JAX file
is not imported: importing it runs the JAX package's ``__init__``, which
imports jax. See the JAX file for the provenance of every default.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Tonemap(enum.Enum):
    """Postprocess ordering (exposure -> gamma -> ACES -> clamp, or
    exposure -> ACES -> gamma)."""

    GAMMA_THEN_ACES = "gamma_then_aces"
    ACES_THEN_GAMMA = "aces_then_gamma"
    NONE = "none"


class OmegaPolicy(enum.Enum):
    """Over-relaxation policy of the enhanced sphere trace."""

    ROLLBACK_TO_ONE = "rollback_to_one"
    ROLLBACK_HALF_UP = "rollback_half_up"
    CONSTANT = "constant"


class HitCriterion(enum.Enum):
    """Sphere-trace hit test: cone (d < t * pixel_radius), relative
    (d / t < pixel_radius) or absolute (d < hit_precision)."""

    CONE = "cone"
    RELATIVE = "relative"
    ABSOLUTE = "absolute"


class Roulette(enum.Enum):
    """Russian roulette: depth-linear survival (wavefront) or the examples'
    exponential continuation."""

    DEPTH_LINEAR = "depth_linear"
    EXP = "exp"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; field for field the JAX ``RenderConfig``.

    Fields the port does not act on yet are kept so that configs convert
    one to one: ``march_chunk``, ``march_tile_rows`` and ``march_phases``
    are TPU kernel knobs with no counterpart here (the CUDA march has one
    thread per lane and exits per lane, or per warp in K1d), accepted and
    ignored; ``env_sampling`` and ``reprojection`` raise in the integrator
    and ``march_compaction`` in ``utils/speedlight``. ``bunny_mxu`` selects
    the tensor-core bunny march K1d.
    """

    resolution: Tuple[int, int] = (768, 432)  # (W, H)

    samples_per_frame: int = 1
    samples_per_pixel: int = 1
    quality_per_sample: float = 0.8

    black_background: bool = False
    adaptive_sampling: bool = False

    visibility: Tuple[float, float] = (1e-4, 1e4)
    noise_threshold: float = 1e-4

    max_raymarch: int = 512
    max_raytrace: int = 512

    env_ior: float = 1.000277

    f0_half: bool = False

    omega: float = 1.6
    omega_policy: OmegaPolicy = OmegaPolicy.ROLLBACK_TO_ONE
    hit_criterion: HitCriterion = HitCriterion.CONE
    hit_precision: float = 1e-4
    march_t0: float = 0.0
    max_dis: float = 1e3

    march_chunk: Optional[int] = None
    march_tile_rows: Optional[int] = None
    march_compaction: bool = False
    march_phases: Optional[Tuple[int, ...]] = None

    escape_bound: bool = False

    env_sampling: bool = False
    mis_specular: bool = True

    # Budget-capped split march of the wavefront integrator: each step
    # marches at most this many trips and carries the exact loop state of
    # unfinished lanes (FrameState.march_state / march_cum).
    march_split: Optional[int] = 32

    bunny_mxu: bool = False

    shadow_diet: bool = True
    shadow_max_raymarch: Optional[int] = None
    shadow_hit_precision: Optional[float] = None

    replay_march_checkpoint: Optional[bool] = None

    roulette: Roulette = Roulette.DEPTH_LINEAR
    light_quality: float = 128.0

    tonemap: Tonemap = Tonemap.GAMMA_THEN_ACES
    gamma: float = 2.2
    clamp_output: bool = True

    low_discrepancy: bool = False

    reprojection: bool = False
    reproject_confidence: float = 0.5
    reproject_history_cap: float = 64.0

    seed: int = 0

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def num_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]

    @property
    def screen_pixel_size(self) -> Tuple[float, float]:
        return (1.0 / self.resolution[0], 1.0 / self.resolution[1])

    @property
    def pixel_radius(self) -> float:
        return min(self.screen_pixel_size)

    @property
    def min_dis(self) -> float:
        # surface restart offset
        return 2.5 * self.pixel_radius

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
