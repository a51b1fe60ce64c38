"""Progressive renderer daemon (port of
``raytracingpbr_tpu/apps/progressive.py``): the live loop without a GUI.
It accumulates wavefront frames for ``--minutes``, writes the tonemapped
framebuffer and a checkpoint (``state.npz``) every ``save_every`` frames
and at the end, and resumes bit-exactly from the checkpoint it finds in
``--out``, whichever package wrote it. ``--serve PORT`` serves a live
preview of the frames (``apps/preview.py``); ``--adaptive --compact-every
N`` repacks the state actives-first every N frames (``ops/compact.py``).
Runs on the card; ``--device cpu`` renders on the CPU.

Usage:
    python -m raytracingpbr_tpu_torch.apps.progressive --scene demo \
        --minutes 2 --out out/progressive
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.device import resolve
from ..core.types import make_frame_state
from ..io import checkpoint as ckpt
from ..io import image as imageio
from ..ops import compact as compactlib
from ..ops import integrator as integ
from ..utils.profiling import MetricsLogger


def _save_debug_views(state, cfg, out_dir):
    """The adaptive-sampling noise map and the ray-depth heat map."""
    def to_img(flat):
        return flat.detach().cpu().numpy().reshape(
            cfg.width, cfg.height).transpose(1, 0)[::-1]

    noise = np.clip(to_img(state.noise) * 1e3, 0, 1)
    depth = np.clip(np.abs(to_img(state.rays.depth)) / 3.0, 0, 1)
    imageio.write_png(os.path.join(out_dir, "debug_noise.png"),
                      np.repeat(noise[..., None], 3, -1))
    imageio.write_png(os.path.join(out_dir, "debug_depth.png"),
                      np.repeat(depth[..., None], 3, -1))


def run(scene, env, cam, cfg, out_dir: str, minutes: float = 1.0,
        save_every: int = 50, exposure: float = 1.0,
        metrics_path: str | None = None, debug_views: bool = False,
        validate: bool = False, serve: int | None = None,
        serve_host: str = "127.0.0.1", compact_every: int = 0,
        frames: int | None = None) -> None:
    """Render frames until ``minutes`` have passed (or ``frames`` frames
    were rendered, whichever comes first), on the scene's device.

    ``serve``: a port for the live preview (``apps/preview.py``; 0 picks
    a free one), bound to ``serve_host``. ``compact_every``: with
    ``cfg.adaptive_sampling``, every that many frames the persistent state
    is repacked actives-first (``ops/compact.py``) and the frames render
    over the lane -> pixel map; each frame's pixels are put in raster
    order through the map they were rendered with, before it changes, and
    checkpoints and debug views are written in raster order."""
    os.makedirs(out_dir, exist_ok=True)
    server = None
    if serve is not None:
        from .preview import PreviewServer
        server = PreviewServer(serve, host=serve_host).start()
    ckpt_path = os.path.join(out_dir, "state.npz")
    if os.path.exists(ckpt_path):
        state, _ = ckpt.load(ckpt_path, device=scene.device)
        print(f"resumed from frame {int(state.frame)}", flush=True)
    else:
        state = make_frame_state(cfg.num_pixels, device=scene.device)

    compacting = compact_every > 0 and cfg.adaptive_sampling
    pixel_id = torch.arange(cfg.num_pixels, dtype=torch.int64,
                            device=scene.device)

    def raster(flat, pid):
        """Host pixels (N, 3) in the lane order of ``pid`` -> (H, W, 3),
        row 0 at the top."""
        if compacting:
            flat = compactlib.scatter_pixels(flat, pid, cfg)
        return flat.reshape(cfg.width, cfg.height, 3).transpose(1, 0, 2)[::-1]

    def to_raster(st):
        return (compactlib.uncompact_frame_state(st, pixel_id)
                if compacting else st)

    log = MetricsLogger(metrics_path)
    deadline = time.time() + minutes * 60
    img = None
    done = 0
    try:
        while time.time() < deadline and (frames is None or done < frames):
            done += 1
            t0 = time.time()
            pixels, state = integ.render_frame_tile(
                scene, env, cam, state, cfg, pixel_id, exposure=exposure)
            host_px = pixels.cpu().numpy()
            dt = time.time() - t0
            f = int(state.frame)
            accum = state.accum.cpu().numpy()
            # the raster through the map these pixels were rendered with
            img = raster(host_px, pixel_id)
            extra = {}
            if compacting and f % compact_every == 0:
                state, new_id = compactlib.compact_frame_state(
                    state, pixel_id, cfg.noise_threshold)
                extra["lanes_moved"] = int((new_id != pixel_id).sum())
                pixel_id = new_id
            stats = log.frame_stats(host_px, accum, dt, frame=f, **extra)
            if server is not None:
                server.update(img, **stats)
            if validate:
                from ..utils.validate import assert_state_finite
                assert_state_finite(state)
            if f % save_every == 0:
                imageio.write_png(os.path.join(out_dir, "latest.png"), img)
                ckpt.save(ckpt_path, to_raster(state), meta={"frame": f})
                if debug_views:
                    _save_debug_views(to_raster(state), cfg, out_dir)
        if img is not None:
            imageio.write_png(os.path.join(out_dir, "final.png"), img)
            ckpt.save(ckpt_path, to_raster(state),
                      meta={"frame": int(state.frame)})
            if debug_views:
                _save_debug_views(to_raster(state), cfg, out_dir)
    finally:
        log.close()
        if server is not None:
            server.stop()


def scene_setup(name: str, scale: int = 1, nee: bool = False,
                adaptive: bool = False, device=None):
    """``(scene, env, cam, cfg, exposure)`` of the app's ``--scene``
    (``demo``: the engine scene under its HDR sky; ``cornell``: the full
    Cornell box), divided by ``scale``, with ``cfg.env_sampling`` and the
    baked table under ``nee`` (ValueError for a sky that is not HDR)
    and ``cfg.adaptive_sampling`` under ``adaptive``."""
    from ..models import cornell, demo
    from ..ops.ibl import with_env_sampler

    dev = resolve(device)
    if name == "demo":
        scene, cfg = demo.engine_scene(dev), demo.engine_config()
        cam, env = demo.engine_camera(dev), demo.engine_environment(
            device=dev)
        exposure = 1.0
    else:
        scene, cfg = cornell.full_scene(dev), cornell.full_config()
        cam, env = cornell.full_camera(dev), cornell.sky(dev)
        exposure = 0.6
    if scale > 1:
        cfg = cfg.replace(resolution=(cfg.width // scale,
                                      cfg.height // scale))
    if nee:
        env = with_env_sampler(env)  # raises for non-HDR skies
        cfg = cfg.replace(env_sampling=True)
    if adaptive:
        cfg = cfg.replace(adaptive_sampling=True)
    return scene, env, cam, cfg, exposure


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="demo", choices=["demo", "cornell"])
    p.add_argument("--minutes", type=float, default=1.0)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after this many frames (or --minutes, "
                        "whichever comes first)")
    p.add_argument("--scale", type=int, default=1,
                   help="resolution divisor vs the reference workload")
    p.add_argument("--out", default="out/progressive")
    p.add_argument("--metrics", default=None)
    p.add_argument("--validate", action="store_true",
                   help="assert FrameState finiteness every frame "
                        "(NaN/Inf debugging, utils/validate.py)")
    p.add_argument("--debug-views", action="store_true",
                   help="also write the adaptive-noise map and ray-depth "
                        "heat map")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live browser preview of the converging "
                        "framebuffer on this port (/, /frame.png, /stream, "
                        "/stats; 0 = pick a free port)")
    p.add_argument("--serve-host", default="127.0.0.1", metavar="HOST",
                   help="preview bind address (loopback by default; the "
                        "endpoints are unauthenticated)")
    p.add_argument("--nee", action="store_true",
                   help="env importance sampling + specular MIS "
                        "(cfg.env_sampling; HDR-sky scenes only)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive sampling (cfg.adaptive_sampling)")
    p.add_argument("--compact-every", type=int, default=0, metavar="N",
                   help="with --adaptive: every N frames, repack the "
                        "persistent state actives-first so that converged "
                        "pixels fill whole warps the march skips "
                        "(ops/compact.py; 0 = off)")
    p.add_argument("--device", default=None,
                   help="where to render: the card unless given (the "
                        "tests pass 'cpu')")
    args = p.parse_args(argv)
    scene, env, cam, cfg, exposure = scene_setup(
        args.scene, args.scale, args.nee, args.adaptive, args.device)
    run(scene, env, cam, cfg, args.out, minutes=args.minutes,
        exposure=exposure, metrics_path=args.metrics,
        validate=args.validate, debug_views=args.debug_views,
        serve=args.serve, serve_host=args.serve_host,
        compact_every=args.compact_every, frames=args.frames)


if __name__ == "__main__":
    main()
