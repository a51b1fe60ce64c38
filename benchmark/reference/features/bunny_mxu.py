"""The ``bunny_mxu`` render path: the march with the bunny's MLP in its
matrix form, the plain version of the program's tensor-core march (K1d,
``csrc/march_mxu.cu``).

K1d runs the MLP's two 16x16 hidden layers as ``mma.sync`` products in
3xTF32 (each float32 operand split into a TF32 head and tail, three
products summed) and the rest of the MLP, the shapes and the march's
bookkeeping in float32. This stage evaluates every layer of the MLP with
plain float32 matrix products (``shapes/bunny.mlp_matmul``) and is
otherwise the base march. So the two differ in the order in which each
contraction is summed and in 3xTF32 against float32 products, by about
a float32 rounding a product: the march's hit test can then end a lane
one trip apart, and a lane that grazes a surface can be sent on another
path, as the program's own bar on K1d allows
(``ops/march.assert_march_close``).

This module leaves the TF32 switches alone: the harness turns TF32 off
for the check, and the ``tf32`` control turns it on, so that the
control's matrix products here run in 1xTF32.

A matrix product takes one dtype, and the base renderer's restart offset
(Python floats through ``torch.where``) is float32 whatever the scene's
dtype: so both stages here hand the MLP points in the scene's dtype. In
float32, the check's dtype and the ``tf32`` control's, that changes no
bit; in the ``bfloat16`` control it keeps the march and the normal in
bfloat16, as the control means them to be."""
from __future__ import annotations

from ..march import march as base_march
from ..render import interaction as base_interaction


def march(scene, origin, direction, rc: dict, budget: int, active=None,
          init=None, chains: bool = True, on_trip=None):
    """The base march (``reference/march.py``) with ``chains`` False,
    whatever the caller asks: the bunny MLP with matrix products."""
    dtype = scene.position.dtype
    return base_march(scene, origin.to(dtype), direction.to(dtype), rc,
                      budget, active, init, chains=False, on_trip=on_trip)


def interaction(scene, index, position, direction, u, rc: dict, **kw):
    """The base interaction at the hit point in the scene's dtype, where
    the normal evaluates the MLP with matrix products."""
    return base_interaction(scene, index, position.to(scene.position.dtype),
                            direction, u, rc, **kw)
