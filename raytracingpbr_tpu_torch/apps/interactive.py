"""Headless interactive renderer (port of
``raytracingpbr_tpu/apps/interactive.py``): the reference live app's
controls, driven by a text command stream in place of a window.

Protocol (one command a line on stdin, or scripted via ``run_commands``):
    w/a/s/d     move the camera (fly-cam, damped like SmoothCamera)
    u/n/l/r     rotate the view up/down/left/right (gimbal-clamped)
    z+ / z-     vfov up/down
    x+ / x-     aperture up/down
    c+ / c-     focus up/down
    v+ / v-     exposure up/down (no refresh)
    g           save a PNG screenshot
    q           quit

Each command advances the damped camera and renders one progressive
frame; camera motion refreshes the accumulation as the reference does, or
with ``--reproject`` warps it into the new view (``ops/reproject.py``).
Runs on the card; ``--device cpu`` renders on the CPU.

Usage:
    python -m raytracingpbr_tpu_torch.apps.interactive --reproject
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..core.types import make_camera, make_frame_state
from ..io import image as imageio
from ..ops import camera as cameralib
from ..ops import integrator as integ


class InteractiveSession:
    def __init__(self, scene, env, cfg, out_dir: str = "out/interactive",
                 position=(0.0, -0.2, 4.0), lookat=(0.0, -0.2, 3.0),
                 dt: float = 1.0 / 30.0):
        self.scene, self.env, self.cfg = scene, env, cfg
        self.device = scene.device
        self.out_dir = out_dir
        self.dt = dt
        # the reference camera's defaults
        self.vfov, self.aperture, self.focus, self.exposure = \
            35.0, 0.01, 4.0, 1.0
        self.target_pos = np.asarray(position, np.float32)
        self.target_look = np.asarray(lookat, np.float32)
        self.smooth = cameralib.make_smooth_camera(position, lookat,
                                                   device=self.device)
        self.state = make_frame_state(cfg.num_pixels, device=self.device)
        self.pixels = None
        self._prev_cam = None
        self.frames = 0

    def _camera(self):
        return make_camera(
            lookfrom=self.smooth.position, lookat=self.smooth.lookat,
            vfov=self.vfov, aspect=self.cfg.width / self.cfg.height,
            aperture=self.aperture, focus=self.focus, device=self.device)

    def handle(self, cmd: str) -> bool:
        """Apply one command; returns False on quit."""
        cmd = cmd.strip()
        refreshing = False
        speed = 5.0 * self.dt  # the reference's movement speed
        front = self.target_look - self.target_pos
        front = front / (np.linalg.norm(front) + 1e-9)
        right = np.cross(front, [0.0, 1.0, 0.0])
        if cmd == "q":
            return False
        elif cmd == "w":
            self.target_pos += speed * front
            self.target_look += speed * front
        elif cmd == "s":
            self.target_pos -= speed * front
            self.target_look -= speed * front
        elif cmd == "a":
            self.target_pos -= speed * right
            self.target_look -= speed * right
        elif cmd == "d":
            self.target_pos += speed * right
            self.target_look += speed * right
        elif cmd in ("l", "r", "u", "n"):
            dyaw = {"l": -1.0, "r": 1.0}.get(cmd, 0.0) * self.dt
            dpitch = {"u": 1.0, "n": -1.0}.get(cmd, 0.0) * self.dt
            new_look = cameralib.fly_rotate(
                torch.as_tensor(self.target_pos),
                torch.as_tensor(self.target_look), dyaw, dpitch)
            self.target_look = new_look.numpy()
        elif cmd in ("z+", "z-"):
            self.vfov += (10 * self.dt) * (1 if cmd == "z+" else -1)
            refreshing = True
        elif cmd in ("x+", "x-"):
            self.aperture += self.dt * (1 if cmd == "x+" else -1)
            refreshing = True
        elif cmd in ("c+", "c-"):
            self.focus += self.dt * (1 if cmd == "c+" else -1)
            refreshing = True
        elif cmd in ("v+", "v-"):
            # exposure does not refresh
            self.exposure += self.dt * (1 if cmd == "v+" else -1)
        elif cmd == "g":
            self.screenshot()
        self.step(refreshing)
        return True

    def step(self, refreshing: bool = False):
        """Advance the damped camera one ``dt`` and render one frame."""
        as_dev = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                           device=self.device)
        self.smooth = cameralib.smooth_update(
            self.smooth, self.dt, as_dev(self.target_pos),
            as_dev(self.target_look), as_dev([0.0, 1.0, 0.0]))
        moving = bool(self.smooth.moving)
        cam = self._camera()
        if ((refreshing or moving) and self.cfg.reprojection
                and self._prev_cam is not None):
            self.pixels, self.state = integ.render_frame(
                self.scene, self.env, cam, self.state, self.cfg,
                refreshing=True, exposure=self.exposure,
                prev_cam=self._prev_cam)
        else:
            self.pixels, self.state = integ.render_frame(
                self.scene, self.env, cam, self.state, self.cfg,
                refreshing=refreshing or moving, exposure=self.exposure)
        self._prev_cam = cam
        self.frames += 1

    def screenshot(self, path: str | None = None):
        os.makedirs(self.out_dir, exist_ok=True)
        img = self.pixels.cpu().numpy().reshape(
            self.cfg.width, self.cfg.height, 3).transpose(1, 0, 2)[::-1]
        path = path or os.path.join(self.out_dir,
                                    f"shot_{self.frames:05d}.png")
        imageio.write_png(path, img)
        return path

    def run_commands(self, commands):
        for c in commands:
            if not self.handle(c):
                break


def session_setup(scale: int = 1, reproject: bool = False, device=None,
                  **kw) -> InteractiveSession:
    """The app's session: the engine scene under its sky at the engine
    config's 768x432 divided by ``scale``, ``cfg.reprojection`` under
    ``reproject``, on ``device`` (the card unless given)."""
    from ..core.device import resolve
    from ..models import demo
    dev = resolve(device)
    cfg = demo.engine_config()
    if scale > 1:
        cfg = cfg.replace(resolution=(cfg.width // scale,
                                      cfg.height // scale))
    if reproject:
        cfg = cfg.replace(reprojection=True)
    return InteractiveSession(demo.engine_scene(dev),
                              demo.engine_environment(device=dev), cfg, **kw)


def main(argv=None, stdin=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scale", type=int, default=1,
                   help="resolution divisor vs the engine default")
    p.add_argument("--reproject", action="store_true",
                   help="warp accumulation on camera motion instead of "
                        "resetting it (temporal reprojection)")
    p.add_argument("--out", default="out/interactive",
                   help="where the 'g' screenshots go")
    p.add_argument("--device", default=None,
                   help="where to render: the card unless given (the "
                        "tests pass 'cpu')")
    args = p.parse_args(argv)
    sess = session_setup(args.scale, args.reproject, args.device,
                         out_dir=args.out)
    sess.step()
    print("interactive session ready; commands: w/a/s/d l/r/u/n z+ z- x+ "
          "x- c+ c- v+ v- g q", flush=True)
    for line in (stdin or sys.stdin):
        if not sess.handle(line):
            break
        spp = float(sess.state.accum[:, 3].mean())
        print(f"frame {sess.frames} spp~{spp:.1f}", flush=True)


if __name__ == "__main__":
    main()
