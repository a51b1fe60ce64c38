"""Two-process sharded render and train step of the port (its counterpart
of ``tools/multihost_demo.py``).

    python -m raytracingpbr_tpu_torch.apps.multihost [--device cpu]

Starts two worker processes that join one
``torch.distributed`` group through ``parallel/mesh.multihost_init`` (a
file store under a fresh temporary directory: no port to collide on) and
share a (tiles, samples) mesh, each running its block of ranks
(``--mesh 8x1``: four each). Each renders only its pixels; the image is
gathered, and rank 0 saves it. The parent then renders the same mesh in
one process and asserts the two images bit-identical: the counter RNG is
keyed on global pixel ids, and the partial sums are combined in
mesh-rank order. With ``--train-steps N`` the workers also take N train
steps on a (4, 2) mesh (albedo only, from a darkened albedo towards the
scene's own render), held to the one-process mesh's losses and albedo
at rtol 1e-5 (a process adds its batch's gradients in its own order);
with ``--frames N``, N reprojected frames on ``--mesh`` (bit-identical on
the CPU; on the card the warp's atomics hold it to rtol 1e-5 on 99.9% of
pixels). Prints ``MULTIHOST OK`` on success.

The card is used unless ``--device cpu``. ``--backend`` defaults to gloo:
two processes on one card cannot form an NCCL group; gloo stages the
gathered tensors through host memory (``parallel/mesh``). On the card the
parent builds the kernels before it starts the workers, which load them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..core.device import resolve
from ..core.types import make_frame_state
from ..models import cornell
from ..parallel import mesh as meshlib
from ..parallel import render as prender
from ..parallel import train as ptrain

NPROC = 2
SPP = 2
TRAIN_MESH = (4, 2)
TRAIN_BOUNCES = 8
SCENES = {
    "cornell_minimal": (cornell.minimal_scene, cornell.minimal_camera,
                        cornell.minimal_config),
    "cornell_full": (cornell.full_scene, cornell.full_camera,
                     cornell.full_config),
}


def _mesh_shape(text: str):
    tiles, samples = text.lower().split("x")
    return int(tiles), int(samples)


def setup(scene: str, resolution: int, max_raymarch: int,
          max_raytrace: int, device):
    """The Cornell scene, its sky and camera, and its config at
    ``resolution`` squared with the given march and bounce budgets."""
    scene_fn, cam_fn, cfg_fn = SCENES[scene]
    cfg = cfg_fn().replace(resolution=(resolution, resolution),
                           max_raymarch=max_raymarch,
                           max_raytrace=max_raytrace)
    return scene_fn(device), cornell.sky(device), cam_fn(device), cfg


def work(scene, env, cam, cfg, mesh, spp: int, train_mesh=None,
         train_steps: int = 0, frames: int = 0) -> dict:
    """What every process runs: the sharded still (untonemapped) on
    ``mesh``; with ``frames``, that many progressive frames on ``mesh``
    under the strided layout with ``cfg.reprojection``, a 0.08 move of the
    camera and a reprojected refresh (the warp gathers the state across
    processes); then ``train_steps`` train steps on ``train_mesh`` at
    TRAIN_BOUNCES bounces at most.
    Returns host arrays: ``image``, ``frame`` (the gathered image of the
    last frame), ``losses`` and ``albedo``."""
    out = {"image": prender.render_image_sharded(
        scene, env, cam, cfg, mesh, spp=spp, tonemapped=False).cpu().numpy()}
    if frames:
        fcfg = cfg.replace(samples_per_frame=2, reprojection=True)
        state = prender.shard_frame_state(
            make_frame_state(fcfg.num_pixels, device=scene.device), mesh,
            "strided")
        for _ in range(frames):
            px, state = prender.render_frame_sharded(
                scene, env, cam, state, fcfg, mesh, layout="strided")
        moved = dataclasses.replace(cam, lookfrom=cam.lookfrom + torch.tensor(
            [0.08, 0.0, 0.0], device=scene.device))
        px, state = prender.render_frame_sharded(
            scene, env, moved, state, fcfg, mesh, refreshing=True,
            prev_cam=cam, layout="strided")
        out["frame"] = prender.gather_image(px, fcfg, mesh,
                                            "strided").cpu().numpy()
    if train_steps:
        tcfg = cfg.replace(max_raytrace=min(cfg.max_raytrace, TRAIN_BOUNCES))
        pixel_id = torch.arange(tcfg.num_pixels, device=scene.device)
        target = ptrain.render_pixels(scene, env, cam, pixel_id, tcfg,
                                      spp=2, sample_offset=10_000,
                                      differentiable=False)
        step = ptrain.make_sharded_train_step(
            env, cam, tcfg, train_mesh, spp=1,
            param_filter=ptrain.albedo_only_filter)
        ts = ptrain.make_train_state(scene.replace(albedo=scene.albedo * 0.8),
                                     ptrain.adam(0.02))
        losses = []
        for _ in range(train_steps):
            ts, loss = step(ts, target)
            losses.append(float(loss))
        out["losses"] = np.array(losses)
        out["albedo"] = ts.scene.albedo.detach().cpu().numpy()
    return out


def _run(args, group=None) -> dict:
    device = resolve(args.device)
    scene, env, cam, cfg = setup(args.scene, args.resolution,
                                 args.max_raymarch, args.max_raytrace, device)
    mesh = meshlib.make_mesh(*_mesh_shape(args.mesh), group=group)
    train_mesh = meshlib.make_mesh(*TRAIN_MESH, group=group)
    return work(scene, env, cam, cfg, mesh, SPP, train_mesh,
                args.train_steps, args.frames)


def worker(args) -> None:
    import torch.distributed as dist
    meshlib.multihost_init(args.init, NPROC, args.worker, args.backend)
    try:
        t0 = time.perf_counter()
        out = _run(args, dist.group.WORLD)
        secs = time.perf_counter() - t0
        ranks = meshlib.make_mesh(*_mesh_shape(args.mesh)).local_ranks()
        print(f"[process {args.worker}] ranks {list(ranks)} of mesh "
              f"{args.mesh}: image {out['image'].shape}, mean "
              f"{out['image'].mean():.6f}, {secs:.2f} s", flush=True)
        if args.worker == 0:
            np.savez(args.out, **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu, or the card (default)")
    p.add_argument("--backend", default="gloo", help="gloo or nccl")
    p.add_argument("--scene", default="cornell_minimal", choices=SCENES)
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--max-raymarch", type=int, default=96)
    p.add_argument("--max-raytrace", type=int, default=6)
    p.add_argument("--mesh", default="8x1", help="TILESxSAMPLES")
    p.add_argument("--train-steps", type=int, default=0)
    p.add_argument("--frames", type=int, default=0,
                   help="reprojected progressive frames on --mesh")
    p.add_argument("--out", default=None,
                   help="directory for multihost.npz (the workers' result "
                        "and the one-process reference)")
    p.add_argument("--worker", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.worker is not None:
        worker(args)
        return
    if resolve(args.device).type == "cuda":
        from ..kernels import build
        build.build_all()  # once, here: the workers load what it built
    tmp = tempfile.mkdtemp(prefix="rt_multihost_")
    try:
        result = os.path.join(tmp, "workers.npz")
        base = [sys.executable, "-m", "raytracingpbr_tpu_torch.apps.multihost",
                *(argv if argv is not None else sys.argv[1:]),
                "--init", f"file://{os.path.join(tmp, 'store')}",
                "--out", result, "--worker"]
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        logs = [os.path.join(tmp, f"worker{i}.log") for i in range(NPROC)]
        t0 = time.perf_counter()
        procs = []
        for i in range(NPROC):
            with open(logs[i], "w") as f:
                procs.append(subprocess.Popen(base + [str(i)], env=env,
                                              cwd=root, stdout=f,
                                              stderr=subprocess.STDOUT))
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for i in range(NPROC):
            with open(logs[i]) as f:
                print("\n".join(f"  {line}" for line in
                                f.read().splitlines()[-20:]), flush=True)
        if rcs != [0] * NPROC:
            raise SystemExit(f"worker exit codes {rcs}")
        got = dict(np.load(result))
        t1 = time.perf_counter()
        ref = _run(args)
        ref_secs = time.perf_counter() - t1
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.savez(os.path.join(args.out, "multihost.npz"),
                     **{f"workers_{k}": v for k, v in got.items()},
                     **{f"single_{k}": v for k, v in ref.items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    np.testing.assert_array_equal(got["image"], ref["image"])
    if args.frames:
        if resolve(args.device).type == "cpu":
            np.testing.assert_array_equal(got["frame"], ref["frame"])
        else:  # the warp's atomic adds reorder a pixel's sums
            close = np.isclose(got["frame"], ref["frame"], rtol=1e-5,
                               atol=0).all(-1).mean()
            assert close >= 0.999, close
        print(f"{args.frames} frames and a reprojected refresh on "
              f"{args.mesh}, strided: as one process", flush=True)
    print(f"{NPROC} processes x {args.mesh} mesh: {secs:.2f} s with "
          f"start-up; one process {ref_secs:.2f} s", flush=True)
    if args.train_steps:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["albedo"], ref["albedo"], rtol=1e-5)
        same = (np.array_equal(got["losses"], ref["losses"])
                and np.array_equal(got["albedo"], ref["albedo"]))
        print(f"train {TRAIN_MESH[0]}x{TRAIN_MESH[1]}, {args.train_steps} "
              f"steps: losses "
              f"{got['losses'].tolist()}; within rtol 1e-5 of one process"
              f"{', bit-identical' if same else ''}", flush=True)
    print(f"MULTIHOST OK: {NPROC}-process render bit-identical to "
          "single-process", flush=True)


if __name__ == "__main__":
    main()
