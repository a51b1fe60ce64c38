"""The neural bunny: the scene's sin-MLP (3 -> 16 -> 16 -> 16 -> 1) inside
its unit sphere, ``|p| - 0.8`` outside it."""
import torch

from .. import scene as sc

ID = 6
WEIGHTS = True
# the radius inside which the MLP is evaluated (the march's work counts it)
SUPPORT_RADIUS = 1.0


def mlp_matmul(mlp: tuple, p: torch.Tensor) -> torch.Tensor:
    """The bunny MLP with matrix products, ``(..., 3) -> (...)``."""
    w_in, b_in, w_h1, b_h1, w_h2, b_h2, w_out, bias_out = mlp
    f0 = torch.sin(p @ w_in + b_in)
    f1 = torch.sin(f0 @ w_h1 + b_h1) + f0
    f2 = torch.sin(f1 @ w_h2 + b_h2) / 1.4 + f1
    return f2 @ w_out + bias_out


def _chain(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    acc = f[..., 0:1] * w[0]
    for j in range(1, w.shape[0]):
        acc = acc + f[..., j:j + 1] * w[j]
    return acc


def mlp_chains(mlp: tuple, px, py, pz) -> torch.Tensor:
    """The bunny MLP as left-to-right chains of products, each rounded on
    its own (the march kernels' order)."""
    w_in, b_in, w_h1, b_h1, w_h2, b_h2, w_out, bias_out = mlp
    px, py, pz = px[..., None], py[..., None], pz[..., None]
    f0 = torch.sin(px * w_in[0] + py * w_in[1] + pz * w_in[2] + b_in)
    f1 = torch.sin(_chain(f0, w_h1) + b_h1) + f0
    f2 = torch.sin(_chain(f1, w_h2) + b_h2) * (1.0 / 1.4) + f1
    return _chain(f2, w_out[:, None])[..., 0] + bias_out


def sd(scene, lo, hi, p, chains):
    """``chains``: the MLP in the march kernels' order; else with matrix
    products."""
    mlp = scene.bunny
    if chains:
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        r = torch.sqrt(px * px + py * py + pz * pz)
        return torch.where(r > 1.0, r - 0.8, mlp_chains(mlp, px, py, pz))
    r = sc.safe_norm(p)
    return torch.where(r > 1.0, r - 0.8, mlp_matmul(mlp, p))
