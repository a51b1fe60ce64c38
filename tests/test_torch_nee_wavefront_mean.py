"""The progressive (wavefront) estimator's mean with and without NEE on the
sun-lit scene at a 64-bounce budget, within rel 0.15: the bar of
``tests/test_nee.py:158-172`` with its scene, size and spp, on the CPU.
Its own file: 192 spp of 12x12 pixels take about a thousand wavefront
steps a run, each overhead-bound on the CPU (about 40 s for both runs)."""
import pytest

from raytracingpbr_tpu_torch import Roulette
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import integrator as tinteg

from .test_torch_nee_stats import CAM, base_cfg, sun_env, sun_scene


def test_wavefront_mean():
    scene, env = sun_scene(), sun_env()
    cfg = base_cfg(max_raytrace=64, roulette=Roulette.DEPTH_LINEAR)
    off, _ = tinteg.render_image_progressive(scene, env, CAM, cfg, spp=192,
                                             tonemapped=False)
    on, _ = tinteg.render_image_progressive(
        scene, tibl.with_env_sampler(env), CAM,
        cfg.replace(env_sampling=True), spp=192, tonemapped=False)
    m_off, m_on = float(off.mean()), float(on.mean())
    assert m_on == pytest.approx(m_off, rel=0.15), (m_on, m_off)
