"""The work a march call needs and the least time an H100 could take for
it: a frozen copy of the program's ``utils/speedlight.march_flops_per_iter``
and ``march_bound`` arithmetic with the published peaks of one H100 SXM at
its 700 W limit (NVIDIA's data sheet: 67 TFLOP/s FP32 outside the tensor
cores, 495 TFLOP/s TF32 dense, 3.35 TB/s). It counts what the inputs need
(the lane-trips to each lane's convergence, the bunny's MLP only on the
trips whose point lies inside its unit sphere), whatever kernel runs them.
"""
from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12

SPHERE, BOX, BUNNY = 1, 2, 6
_SHAPE_FLOPS = {0: 0, SPHERE: 7, BOX: 20, 3: 15, 4: 8, 5: 1}
# the sin-MLP bunny: input layer 48 FMA + 16 sin; two hidden layers of 256
# FMA + 16 sin + 16 residual adds (the second + 16 muls); output 16 FMA +
# add; the support test r (7) + select (1)
_BUNNY_FLOPS = (48 * 2 + 16) + 2 * (256 * 2 + 16 + 16) + 16 + (16 * 2 + 1) + 8
_XFORM_PERM = 3 + 3 + 3
_XFORM_MAT = 3 + 3 + 9 * 2
_COMBINE = 4
_LOOP_OVERHEAD = 34
_ESCAPE_BOUND_EXTRA = 8
_BUNNY_SUPPORT = 8
BUNNY_MLP_FLOPS = _BUNNY_FLOPS - _BUNNY_SUPPORT
BUNNY_CONTRACTION_FLOPS = 2 * 256 * 2
TF32_PASSES = 3
# bytes a lane moves once: origin and direction in, the eight outputs out;
# the gate adds 1 and the resume inputs 16
_LANE_BYTES = 24 + 29


def is_signed_permutation(m) -> bool:
    """Whether a 3x3 matrix (nested lists) is a signed permutation."""
    if any(v not in (-1.0, 0.0, 1.0) for row in m for v in row):
        return False
    rows = all(sum(v != 0 for v in row) == 1 for row in m)
    cols = all(sum(m[r][c] != 0 for r in range(3)) == 1 for c in range(3))
    return rows and cols


def flops_per_iter(shapes, perms, escape_bound: bool = False) -> int:
    """Flops of one march trip of one lane, the MLP counted on every trip
    (``shapes``: each object's shape id; ``perms``: whether its matrix is
    a signed permutation)."""
    total = _LOOP_OVERHEAD + (_ESCAPE_BOUND_EXTRA if escape_bound else 0)
    for t, perm in zip(shapes, perms):
        total += _XFORM_PERM if perm else _XFORM_MAT
        total += _BUNNY_FLOPS if t == BUNNY else _SHAPE_FLOPS[t]
        total += _COMBINE
    return total


def march_bound(shapes, perms, lanes: int, needed: int, support: int,
                gated: bool, resumed: bool, bunny_mxu: bool = False,
                escape_bound: bool = False) -> dict:
    """The least time one march call could take: ``needed`` lane-trips
    times :func:`flops_per_iter`, the bunny's MLP counted only on the
    ``support`` lane-trips inside its unit sphere (with ``bunny_mxu`` the
    two hidden contractions at the TF32 rate, three passes, beside the
    rest at the FP32 rate), against each lane's bytes read and written once
    over the HBM rate. The bound is the larger of the two times."""
    n_bunny = sum(1 for t in shapes if t == BUNNY)
    flops = ((flops_per_iter(shapes, perms, escape_bound)
              - n_bunny * BUNNY_MLP_FLOPS) * needed
             + BUNNY_MLP_FLOPS * support)
    tc = BUNNY_CONTRACTION_FLOPS * support if bunny_mxu else 0
    ops_s = max((flops - tc) / H100_FP32_FLOPS,
                tc * TF32_PASSES / H100_TF32_FLOPS)
    nbytes = lanes * (_LANE_BYTES + (1 if gated else 0)
                      + (16 if resumed else 0))
    bytes_s = nbytes / H100_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "needed": needed,
            "support": support, "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
