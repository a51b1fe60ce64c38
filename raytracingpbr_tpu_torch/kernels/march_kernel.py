"""Hand-written CUDA march kernel K1a (``csrc/march.cu``) and its wrapper.

Replaces the Pallas TPU kernel
``raytracingpbr_tpu/pallas/march_kernel.py::_march_kernel`` on the
wavefront's main path: CONSTANT omega, ABSOLUTE hit test, no escape bound,
analytic shapes, the active gate and the resume from ``(t, w, s, d)``.

What bounds it on an H100: FP32 ALU work, about 8 objects x ~25 flops per
lane-trip on the Cornell path, while a lane reads about 40 bytes once. The
design answers that with one thread per lane and a per-lane loop exit (no
tile ever marches for its slowest lane's sake beyond its own warp), and the
scene staged once per block in shared memory. Specialising the object loop
on the scene's shape-type tuple, and the ``rot_perm`` shortcut, are later
speed work.

The plain PyTorch version is ``ops/march.march_resumable_plain``;
``ops/march.march_resumable`` sends CPU tensors there and CUDA tensors here.
This wrapper never falls back: a CUDA tensor is marched by the kernel, or
the call raises.

Build: ``nvcc`` (route b: a plain C interface bound with ctypes) at first
use, into ``build/raytracingpbr_tpu_torch/`` under the checkout, named after
a hash of the source and flags so a stale build is never loaded. The flags
keep ``-fmad=false`` and no fast math, so kernel and plain version agree
bit for bit on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..ops.sdf import SHAPE

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "march.cu"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "raytracingpbr_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
BLOCK = 256

# Kernel launches made by march_resumable_cuda: a plain counter that a run
# resets and reads to show which path it went through.
LAUNCHES = 0

_lib = None


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
        lib.rt_march_k1a.argtypes = (
            [p, p, i, f, p, p, p, p, p, p, p, f, f, f, f, i, i]
            + [p] * 8 + [i, p])
        lib.rt_march_k1a.restype = i
        lib.rt_march_max_objects.argtypes = []
        lib.rt_march_max_objects.restype = i
        _lib = lib
    return _lib


def pack_scene(scene) -> torch.Tensor:
    """Per-object transform block (n, 32) f32: [pos(3), scale(3), matrix
    row-major (9), local_offset(3), bound^2 slot (1), pad(13)] — the TPU
    kernel's layout. The bound slot stays 0: K1a has no escape bound."""
    n = scene.num_objects
    dev, dt = scene.position.device, scene.position.dtype
    return torch.cat([scene.position, scene.scale, scene.matrix.reshape(n, 9),
                      scene.local_offset, torch.zeros((n, 14), dtype=dt,
                                                      device=dev)], -1)


def _check_variant(scene, cfg: RenderConfig) -> None:
    if cfg.omega_policy != OmegaPolicy.CONSTANT:
        raise NotImplementedError(
            f"the CUDA march serves CONSTANT omega only, not "
            f"{cfg.omega_policy} (kernel variant K1b)")
    if cfg.hit_criterion != HitCriterion.ABSOLUTE:
        raise NotImplementedError(
            f"the CUDA march serves the ABSOLUTE hit test only, not "
            f"{cfg.hit_criterion} (kernel variant K1b)")
    if cfg.escape_bound and SHAPE.PLANE not in scene.shape_types:
        raise NotImplementedError(
            "the CUDA march has no escape bound (kernel variant K1b)")
    if SHAPE.BUNNY in scene.shape_types:
        raise NotImplementedError("the bunny march is kernel variant K1c")


def _vec(x: torch.Tensor, n: int, dtype, name: str) -> torch.Tensor:
    if x.shape != (n,) or x.dtype != dtype or not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA ({n},) {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def march_resumable_cuda(scene, origin: torch.Tensor,
                         direction: torch.Tensor, cfg: RenderConfig,
                         active=None, init=None):
    """Budget-capped resumable march on the card through K1a.

    Same contract as ``ops/march.march_resumable``; returns the tuple
    ``(t, index, hit, fin, w, s, d, done)`` (f32, i32, bool, i32, f32, f32,
    f32, i32), each (N,). Raises NotImplementedError for variants the
    kernel does not serve."""
    global LAUNCHES
    _check_variant(scene, cfg)
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
    params = pack_scene(scene).contiguous()
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
        rc = lib.rt_march_k1a(
            ptr(params), ptr(scene.type_ids), scene.num_objects,
            scene.box_round,
            ptr(origin), ptr(direction), ptr(act), *(ptr(v) for v in inits),
            cfg.march_t0, cfg.omega, cfg.hit_precision, cfg.max_dis,
            cfg.max_raymarch, n, ptr(t), ptr(idx), ptr(hit), ptr(fin),
            ptr(w), ptr(s), ptr(d), ptr(done), BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return t, idx, hit, fin, w, s, d, done
