"""The system under test, built from the benchmark's data.

The one module of the benchmark that imports ``raytracingpbr_tpu_torch``,
and only its public functions: ``make_scene`` / ``ObjectSpec`` for the
scene (the bunny's weights replaced by the benchmark's copy), the
environment constructor a configuration's sky names, ``make_camera``,
``RenderConfig``, ``make_frame_state``, ``render_frame`` and
``render_pixels``. The import
happens inside the functions, so that a directory without the program
fails at the first call and not at import.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import render as ref_render

_ENUMS = {"omega_policy": "OmegaPolicy", "hit_criterion": "HitCriterion",
          "roulette": "Roulette", "tonemap": "Tonemap"}


def port():
    import raytracingpbr_tpu_torch as rt
    return rt


def render_config(render: dict, seed: int):
    """The program's ``RenderConfig`` of a configuration's ``render``
    dict and the run's seed."""
    rt = port()
    kw = {}
    for k, v in render.items():
        if k in _ENUMS:
            v = getattr(rt, _ENUMS[k])(v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return rt.RenderConfig(**kw, seed=int(seed) & 0xFFFFFFFF)


def build(cell, seed: int, device):
    """(scene, environment, camera, config) of the program for a cell: its
    configuration file's data, its render settings (the configuration's
    with the traffic's overrides) and the run's seed. The sky's raw image
    is the reference's (``reference/sky/<kind>.py``), handed to the
    program's constructor that the sky's ``program`` entry names."""
    rt = port()
    data = cell.config
    objs = [rt.ObjectSpec(rt.SHAPE[o["shape"].upper()],
                          tuple(o["position"]), tuple(o["rotation"]),
                          tuple(o["scale"]), albedo=tuple(o["albedo"]),
                          emission=tuple(o["emission"]),
                          roughness=o["roughness"], metallic=o["metallic"],
                          transmission=o["transmission"], ior=o["ior"])
            for o in data["objects"]]
    scene = rt.make_scene(objs, box_round=data["box_round"], device=device)
    if scene.has_bunny:
        # the benchmark's copy of the weights, not the program's asset
        from raytracingpbr_tpu_torch.ops.sdf import BunnyMLP
        with np.load(cell.mlp_path()) as z:
            mlp = BunnyMLP(*(torch.tensor(z[k], dtype=torch.float32,
                                          device=device)
                             for k in BunnyMLP._fields))
        scene = scene.replace(bunny=mlp)
    sky = data["sky"]
    env = environment(sky, ref_render.sky_image(sky), device)
    c = data["camera"]
    cam = rt.make_camera(lookfrom=tuple(c["lookfrom"]),
                         lookat=tuple(c["lookat"]), vup=tuple(c["vup"]),
                         vfov=c["vfov"], aspect=c["aspect"],
                         aperture=c["aperture"], focus=c["focus"],
                         device=device)
    return scene, env, cam, render_config(cell.render(), seed)


def environment(sky: dict, image, device):
    """The program's environment of a configuration's ``sky``: the public
    function that ``sky["program"]`` names (``module``, a module of the
    program's package, empty for the package; ``call``), given the raw
    image first where ``image`` is set, and the sky's fields that
    ``args`` lists."""
    import importlib
    spec = sky["program"]
    name = "raytracingpbr_tpu_torch" + (
        "." + spec["module"] if spec.get("module") else "")
    fn = getattr(importlib.import_module(name), spec["call"])
    head = (image,) if spec.get("image") else ()
    return fn(*head, **{k: sky[k] for k in spec.get("args", ())},
              device=device)


def grad_leaves(scene, names):
    """The program's scene with the named tensors (``albedo``, ``matrix``,
    ``bunny_<field>``) replaced by leaves that require grad. Returns
    ``(make_scene(leaves), leaves)``: ``make_scene`` rebuilds the scene
    around the given leaves."""
    from raytracingpbr_tpu_torch.ops.sdf import BunnyMLP
    src = {"bunny_" + k: v for k, v in zip(BunnyMLP._fields,
                                            scene.bunny or ())}
    leaves = {}
    for n in names:
        v = src[n] if n.startswith("bunny_") else getattr(scene, n)
        leaves[n] = v.detach().clone().requires_grad_(True)

    def make(lv):
        kw = {k: v for k, v in lv.items() if not k.startswith("bunny_")}
        if any(k.startswith("bunny_") for k in lv):
            kw["bunny"] = BunnyMLP(*(lv.get("bunny_" + k, src["bunny_" + k])
                                     for k in BunnyMLP._fields))
        return scene.replace(**kw)

    return make, leaves
