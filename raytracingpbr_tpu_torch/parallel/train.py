"""Inverse rendering: pixel-loss gradients through the differentiable
megakernel to the scene's parameters, and a train step (port of
``raytracingpbr_tpu/parallel/train.py``).

One process, one card: the step renders and backpropagates every pixel
of the image and all of its samples. The JAX package's step splits the
pixels and samples over a device mesh and averages the gradients with
``pmean``; that all-reduce arrives with the distributed port (ROADMAP
Queue 1, item 15), and asking for a process group raises until then.

``optax.adam`` is ``torch.optim.Adam`` over the scene's float buffers
(``scene.params``), stepped in place; ``optax.cosine_decay_schedule`` is
:func:`cosine_decay_schedule`, applied through a ``LambdaLR``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.types import Camera
from ..ops import camera as cameralib
from ..ops import integrator as integ
from ..ops import scene as scenelib
from ..ops.ibl import Environment
from ..ops.scene import Scene

def render_pixels(scene: Scene, env: Environment, cam: Camera,
                  pixel_id: torch.Tensor, cfg: RenderConfig, spp: int,
                  sample_offset=0, differentiable=True) -> torch.Tensor:
    """Differentiable linear-radiance estimate (N, 3) for a batch of pixel
    ids: the mean of ``spp`` megakernel samples, sample indices
    ``sample_offset + k`` modulo 2**32 (an int, or an integer tensor).
    The dtype follows the camera (float32, or float64 on the CPU for
    finite-difference oracles).

    ``differentiable``: True is scan-AD (geometry included, memory grows
    with the bounces), ``"replay"`` path replay (materials and environment,
    O(rays) memory; ``ops/replay.py``), False a forward render."""
    dtype = cam.lookfrom.dtype
    acc = torch.zeros((pixel_id.shape[0], 3), dtype=dtype,
                      device=pixel_id.device)
    for k in range(spp):
        s = (sample_offset + k) & integ._MASK
        u_cam = rnglib.uniform4(pixel_id, s, integ._S_CAMERA, cfg.seed,
                                dtype)
        uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height, u_cam[0],
                                u_cam[1])
        rays = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])
        out = integ.megakernel_trace(scene, env, rays, pixel_id, s, cfg,
                                     differentiable=differentiable)
        acc = acc + out.color
    return acc / spp


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: the learning rate at step ``k`` is
    ``init_value * ((1 - alpha) * c + alpha)``, ``c = (1 + cos(pi *
    min(k, decay_steps) / decay_steps)) / 2``."""
    def schedule(k: int) -> float:
        c = 0.5 * (1.0 + math.cos(math.pi * min(k, decay_steps)
                                  / decay_steps))
        return init_value * ((1.0 - alpha) * c + alpha)
    return schedule


def adam(learning_rate) -> Callable[[list], Tuple[torch.optim.Optimizer,
                                                  Optional[Any]]]:
    """``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8): a factory taking the
    tensors to optimize and returning ``(torch.optim.Adam, scheduler or
    None)``. ``learning_rate``: a float, or a schedule ``k -> lr`` (then a
    ``LambdaLR`` over a base rate of 1 sets it before each step)."""
    def init(tensors):
        if callable(learning_rate):
            opt = torch.optim.Adam(tensors, lr=1.0)
            return opt, torch.optim.lr_scheduler.LambdaLR(opt, learning_rate)
        return torch.optim.Adam(tensors, lr=learning_rate), None
    return init


class TrainState(NamedTuple):
    scene: Scene     # its float buffers are the optimizer's, updated in place
    opt_state: Any   # (optimizer, scheduler or None)
    step: int


def make_train_state(scene: Scene, optimizer) -> TrainState:
    """The train state of a copy of ``scene`` (the caller's scene is left as
    it is): ``optimizer`` is a factory such as :func:`adam`'s, given the
    copy's float buffers."""
    scene = scenelib.with_params(
        scene, [v.detach().clone() for v in scenelib.params(scene)])
    return TrainState(scene, optimizer(list(scenelib.params(scene))), 0)


def make_sharded_train_step(
    env: Environment, cam: Camera, cfg: RenderConfig, group=None,
    spp: int = 1, param_filter: Optional[Callable[[Scene], Scene]] = None,
    dual_buffer: bool = True,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The train step on one process: ``step(ts, target) -> (ts, loss)``
    with ``target`` the flat (N, 3) linear-radiance image.

    The step renders every pixel with sample ids from ``step * 2 * spp``
    (the JAX step's block for tile and sample rank 0), takes the scene's
    gradient by scan-AD, applies ``param_filter`` to it (a function of a
    Scene of gradients, e.g. :func:`param_mask`'s; the frozen fields' zero
    gradients leave Adam's update of them exactly 0) and steps the
    optimizer and its schedule.

    ``dual_buffer`` (default on) renders two independent sample sets A and
    B and differentiates the surrogate ``mean(2 (A - target) B)``, whose
    gradient is an unbiased estimate of that of ``|E[render] - target|^2``
    (a single-buffer MSE also differentiates the per-sample variance and
    shrinks contrast). The loss reported is then ``mean((A - target) (B -
    target))``, the unbiased squared bias; without it, the MSE.

    When the filter lets ``matrix`` or ``rotation`` train (no filter, or
    one that keeps them), the updated scene drops its signed-permutation
    records (``rot_perm``), as ``scene.bake`` does: the march kernels read
    a permutation's matrix from them, which an update leaves stale.

    ``group``: a process group to average the gradient over; not ported
    (ROADMAP Queue 1, item 15), so anything but None raises."""
    if group is not None:
        raise NotImplementedError(
            "the train step's all-reduce over a process group is not ported "
            "yet (ROADMAP Queue 1, item 15)")
    keep = getattr(param_filter, "keep", None)
    trains_matrix = (param_filter is None or keep is None
                     or bool({"matrix", "rotation"} & set(keep)))

    def train_step(ts: TrainState, target_flat: torch.Tensor):
        scene = ts.scene
        leaves = [v.detach().requires_grad_(True)
                  for v in scenelib.params(scene)]
        sc = scenelib.with_params(scene, leaves)
        pixel_id = torch.arange(cfg.num_pixels, dtype=torch.int64,
                                device=scene.device)
        base = ts.step * 2 * spp
        img_b = render_pixels(sc, env, cam, pixel_id, cfg, spp=spp,
                              sample_offset=base)
        if dual_buffer:
            with torch.no_grad():
                img_a = render_pixels(scene, env, cam, pixel_id, cfg,
                                      spp=spp, sample_offset=base + spp,
                                      differentiable=False)
            resid = img_a - target_flat
            surrogate = torch.mean(2.0 * resid * img_b)
            loss = torch.mean(resid * (img_b.detach() - target_flat))
        else:
            surrogate = torch.mean((img_b - target_flat) ** 2)
            loss = surrogate.detach()
        grads = torch.autograd.grad(surrogate, leaves, allow_unused=True)
        g = scenelib.with_params(scene, [
            torch.zeros_like(v) if d is None else d
            for v, d in zip(leaves, grads)])
        if param_filter is not None:
            g = param_filter(g)
        opt, schedule = ts.opt_state
        for v, d in zip(scenelib.params(scene), scenelib.params(g)):
            v.grad = d
        opt.step()
        opt.zero_grad(set_to_none=True)
        if schedule is not None:
            schedule.step()
        if trains_matrix and any(p is not None for p in scene.rot_perm):
            scene = scene.replace(rot_perm=(None,) * scene.num_objects)
        return TrainState(scene, ts.opt_state, ts.step + 1), loss

    return train_step


def param_mask(keep) -> Callable[[Scene], Scene]:
    """Gradient filter keeping only the named Scene fields trainable (the
    others' gradients become zeros; the bunny's weights pass). Materials
    compensate each other (emission x albedo), so fitting one property
    from images means freezing the rest. The filter carries ``keep``."""
    keep = frozenset(keep)

    def filt(g: Scene) -> Scene:
        return g.replace(**{k: torch.zeros_like(getattr(g, k))
                            for k in scenelib._BUFFERS if k not in keep})
    filt.keep = keep
    return filt


material_only_filter = param_mask({"albedo", "emission", "roughness",
                                   "metallic", "transmission", "ior"})
"""Zero the geometry and transform gradients: fit materials only."""

albedo_only_filter = param_mask({"albedo"})
