"""Hand-written CUDA march kernels K1a, K1b and K1c (``csrc/march.cu``)
and their wrapper.

They replace the Pallas TPU kernel
``raytracingpbr_tpu/pallas/march_kernel.py::_march_kernel``; one CUDA
template serves every variant, named here by what it adds:

- ``k1a``: CONSTANT omega, ABSOLUTE hit test, no escape bound, analytic
  shapes (the Cornell wavefront's march);
- ``k1b``: the ROLLBACK_TO_ONE / ROLLBACK_HALF_UP policies, the CONE /
  RELATIVE hit tests and the escape bound, on analytic shapes;
- ``k1c``: any of those on a scene with the neural bunny (the MLP of
  ``_bunny_tile``, weights packed by :func:`pack_bunny`).

All have the active gate and the resume from ``(t, w, s, d)``.

What bounds them on an H100: FP32 ALU work (about 25 flops per analytic
object per lane-trip; about 1,300 flops and 48 sinf for a bunny lane inside
the unit sphere), while a lane reads about 40 bytes once. The design
answers that with one thread per lane and a per-lane loop exit, the scene
and the MLP weights staged once per block in shared memory, and the MLP run
per lane only inside its support.

The plain PyTorch version is ``ops/march.march_resumable_plain``;
``ops/march.march_resumable`` sends CPU tensors there and CUDA tensors here.
This wrapper never falls back: a CUDA tensor is marched by a kernel, or the
call raises, naming the kernel that would serve it (``cfg.bunny_mxu`` is
K1d, not ported).

Build: ``nvcc`` (a plain C interface bound with ctypes) at first use, into
``build/raytracingpbr_tpu_torch/`` under the checkout, named after a hash of
the source and flags so a stale build is never loaded. The flags keep
``-fmad=false`` and no fast math, so kernel and plain version agree bit for
bit on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..ops import scene as scenelib
from ..ops.sdf import SHAPE

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "march.cu"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "raytracingpbr_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
BLOCK = 256

# Kernel launches made by march_resumable_cuda, per variant: plain
# counters that a run resets and reads to show which path it went through.
LAUNCHES = {"k1a": 0, "k1b": 0, "k1c": 0}

_POLICY = {OmegaPolicy.CONSTANT: 0, OmegaPolicy.ROLLBACK_TO_ONE: 1,
           OmegaPolicy.ROLLBACK_HALF_UP: 2}
_CRIT = {HitCriterion.ABSOLUTE: 0, HitCriterion.RELATIVE: 1,
         HitCriterion.CONE: 2}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA march "
                       "kernel is built from csrc/march.cu at first use")


def library_path() -> Path:
    """Where the built library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmarch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/march.cu`` unless this exact build exists. Raises
    with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def load():
    """Build if needed, then load the library and declare its C ABI."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rt_march.argtypes = (
            [p, p, p, i, f, p, p, p, p, p, p, p, f, f, f, f, f, f, i, i, i,
             i, i] + [p] * 8 + [i, p])
        lib.rt_march.restype = i
        lib.rt_march_max_objects.argtypes = []
        lib.rt_march_max_objects.restype = i
        _lib = lib
    return _lib


def pack_scene(scene, bound2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-object transform block (n, 32) f32: [pos(3), scale(3), matrix
    row-major (9), local_offset(3), bound^2 (1), pad(13)] — the TPU
    kernel's layout. Column 18 holds ``bound2``, the squared scene bound
    of the escape test (``scene.escape_bound2``, the value the plain march
    compares against), or 0 without one."""
    n = scene.num_objects
    dev, dt = scene.position.device, scene.position.dtype
    b2 = (torch.zeros((n, 1), dtype=dt, device=dev) if bound2 is None
          else bound2.reshape(1, 1).expand(n, 1))
    return torch.cat([scene.position, scene.scale, scene.matrix.reshape(n, 9),
                      scene.local_offset, b2,
                      torch.zeros((n, 13), dtype=dt, device=dev)], -1)


def pack_bunny(scene) -> torch.Tensor:
    """The bunny MLP as a (40, 16) f32 block: rows 0-2 w_in, 3 b_in, 4-19
    w_h1, 20 b_h1, 21-36 w_h2, 37 b_h2, 38 w_out, 39 [bias_out, 0...]."""
    b = scene.bunny
    last = torch.zeros((1, 16), dtype=b.w_in.dtype, device=b.w_in.device)
    last[0, 0] = b.bias_out
    return torch.cat([b.w_in, b.b_in[None], b.w_h1, b.b_h1[None], b.w_h2,
                      b.b_h2[None], b.w_out[None], last], 0)


def variant(scene, cfg: RenderConfig) -> str:
    """The kernel that marches this scene under this config: ``k1a``,
    ``k1b`` or ``k1c``. Raises NotImplementedError for what none serves."""
    if cfg.omega_policy not in _POLICY or cfg.hit_criterion not in _CRIT:
        raise NotImplementedError(
            f"no CUDA march serves {cfg.omega_policy} with "
            f"{cfg.hit_criterion}")
    if SHAPE.BUNNY in scene.shape_types:
        if cfg.bunny_mxu:
            raise NotImplementedError(
                "cfg.bunny_mxu asks for the tensor-core bunny MLP, kernel "
                "K1d, which is not ported; K1c serves bunny_mxu=False")
        return "k1c"
    if (cfg.omega_policy == OmegaPolicy.CONSTANT
            and cfg.hit_criterion == HitCriterion.ABSOLUTE
            and not scenelib.has_escape_bound(scene, cfg)):
        return "k1a"
    return "k1b"


def _vec(x: torch.Tensor, n: int, dtype, name: str) -> torch.Tensor:
    if x.shape != (n,) or x.dtype != dtype or not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA ({n},) {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def march_resumable_cuda(scene, origin: torch.Tensor,
                         direction: torch.Tensor, cfg: RenderConfig,
                         active=None, init=None):
    """Budget-capped resumable march on the card through K1a, K1b or K1c.

    Same contract as ``ops/march.march_resumable``; returns the tuple
    ``(t, index, hit, fin, w, s, d, done)`` (f32, i32, bool, i32, f32, f32,
    f32, i32), each (N,). Raises NotImplementedError for variants no
    kernel serves."""
    kind = variant(scene, cfg)
    if not (origin.is_cuda and direction.is_cuda):
        raise ValueError("march_resumable_cuda takes CUDA tensors")
    n = origin.shape[0]
    for name, v in (("origin", origin), ("direction", direction)):
        if v.shape != (n, 3) or v.dtype != torch.float32:
            raise ValueError(f"{name}: expected ({n}, 3) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if scene.position.device != origin.device:
        raise ValueError(f"scene on {scene.position.device}, rays on "
                         f"{origin.device}")
    lib = load()
    if scene.num_objects > lib.rt_march_max_objects():
        raise NotImplementedError(
            f"{scene.num_objects} objects; the kernel stages at most "
            f"{lib.rt_march_max_objects()} in shared memory")
    origin = origin.contiguous()
    direction = direction.contiguous()
    bound2 = scenelib.escape_bound2(scene, cfg)
    params = pack_scene(scene, bound2).contiguous()
    bunny = pack_bunny(scene).contiguous() if kind == "k1c" else None
    act = None if active is None else _vec(active, n, torch.bool, "active")
    inits = (None,) * 4 if init is None else tuple(
        _vec(v, n, torch.float32, k) for v, k in zip(init, "twsd"))

    f32 = dict(dtype=torch.float32, device=origin.device)
    i32 = dict(dtype=torch.int32, device=origin.device)
    t, w, s, d = (torch.empty((n,), **f32) for _ in range(4))
    idx, fin, done = (torch.empty((n,), **i32) for _ in range(3))
    hit = torch.empty((n,), dtype=torch.bool, device=origin.device)

    if n == 0:
        return t, idx, hit, fin, w, s, d, done
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream(origin.device).cuda_stream
        # c_float rounds each Python float to f32 as PyTorch rounds a
        # scalar operand of an f32 tensor op (the plain march's
        # ``s * (1.0 + 1e-6)`` included), so both compare the same values
        rc = lib.rt_march(
            ptr(params), ptr(scene.type_ids), ptr(bunny), scene.num_objects,
            scene.box_round, ptr(origin), ptr(direction), ptr(act),
            *(ptr(v) for v in inits), cfg.march_t0, cfg.omega,
            cfg.hit_precision, cfg.max_dis, cfg.pixel_radius, 1.0 + 1e-6,
            _POLICY[cfg.omega_policy], _CRIT[cfg.hit_criterion],
            int(bound2 is not None),
            cfg.max_raymarch, n, ptr(t), ptr(idx), ptr(hit), ptr(fin),
            ptr(w), ptr(s), ptr(d), ptr(done), BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"march kernel {kind} launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[kind] += 1
    return t, idx, hit, fin, w, s, d, done
