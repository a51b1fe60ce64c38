"""The benchmark's plain reference: the path tracer in plain PyTorch.

A frozen copy of the arithmetic of ``raytracingpbr_tpu_torch``'s plain
paths as they stood when the benchmark was written: the scene and its SDFs
(``scene.py``), the lock-step sphere trace and its implicit hit-point
gradient (``march.py``), and the RNG, camera, shading, sky, wavefront
frame, differentiable megakernel and tonemap (``render.py``). It imports
nothing of the program and nothing of JAX, builds every derived table
(sorted objects, rotation matrices, baked sky) from the benchmark's data
itself, and follows the device and dtype of the tensors it is given, so
that the same code runs on the CPU in the tests, on the card in float32
for the check, and in bfloat16 or with TF32 matmuls as the lower-precision
control. Each operation is written in the order the program's kernels and
plain paths use, so that on the card the two agree bit for bit wherever
their inputs do.

What a configuration's data selects is a part, found by name in a folder
of its own (:func:`part`), so that a configuration that needs another adds
a file and edits none:

- ``shapes/<shape>.py``: an object's signed distance (``shape`` of each
  object);
- ``sky/<kind>.py``: the sky's raw image, its baking and its lookup
  (``sky.kind``);
- ``omega/<policy>.py``: the march's over-relaxation rule
  (``render.omega_policy``);
- ``hit/<criterion>.py``: the march's hit test (``render.hit_criterion``);
- ``features/<name>.py``: a render path beyond the plain one (the
  configuration's ``reference_features``). Such a module defines any of
  the stages in :data:`BASE` under the stage's name, and the reference
  then runs it in the base's place (:func:`stage`).
"""
from __future__ import annotations

import functools
import importlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the reference's stages by name: what a feature module may replace
BASE: dict = {}


@functools.lru_cache(maxsize=None)
def part(group: str, name: str):
    """The module ``reference/<group>/<name>.py``. Raises ValueError,
    naming the file to add, where there is none."""
    if not name.isidentifier() or not (ROOT / group / f"{name}.py").is_file():
        raise ValueError(f"the reference has no {group} {name!r}: a "
                         f"configuration that needs it adds "
                         f"benchmark/reference/{group}/{name}.py")
    return importlib.import_module(f"{__name__}.{group}.{name}")


def base(name: str):
    """Registers the decorated function as the base of stage ``name``."""
    def register(fn):
        BASE[name] = fn
        return fn
    return register


def stage(rc: dict, name: str):
    """Stage ``name`` for the render settings ``rc``: that of the last of
    ``rc['features']`` whose module defines it, else the base."""
    for f in reversed(rc.get("features", ())):
        fn = getattr(part("features", f), name, None)
        if fn is not None:
            return fn
    return BASE[name]
