"""raytracingpbr_tpu_torch — the PyTorch/CUDA port of ``raytracingpbr_tpu``.

Same module names as the JAX package, written in PyTorch's idiom: scenes are
``nn.Module``s of buffers, rays / cameras / frame states are dataclasses of
tensors, and every function follows the device of the tensors it is given.
Every kernel the JAX package wrote in Pallas for the TPU is a hand-written
CUDA kernel here (``csrc/``), built at first use; the plain PyTorch version
of each stays beside it and serves CPU tensors. This package never imports
jax.
"""

from .config import (DEFAULT_CONFIG, HitCriterion, OmegaPolicy, RenderConfig,
                     Roulette, Tonemap)
from .core.types import (Camera, FrameState, Rays, make_camera,
                         make_frame_state, make_rays, refresh)
from .ops.ibl import (Environment, black_sky, constant_sky, gradient_sky,
                      white_sky)
from .ops.integrator import (render_frame, render_image_progressive,
                             wavefront_step)
from .ops.march import march, march_resumable
from .ops.scene import ObjectSpec, Scene, make_scene
from .ops.sdf import SHAPE

__version__ = "0.1.0"
