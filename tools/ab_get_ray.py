"""Where ``get_ray``'s primary rays part between the card and the CPU, op by
op, on one NVIDIA card (imports no jax):

    PYTHONPATH=. python3 tools/ab_get_ray.py

The rays are ``bench.py``'s utilization rays, the Cornell full box's
480x480 primaries (``bench.utilization_rays``: ``uniform4``, ``pixel_uv``,
``ops/camera.get_ray``), with ``get_ray`` written out one op at a time
(the chain is checked against ``get_ray`` itself on both devices, bit for
bit). For each op it prints the share of output lanes bit-equal between
the card and the CPU, two ways:

* ``own``: the card runs the op on the CPU's inputs, so only the op's own
  rounding is seen;
* ``chained``: the card runs the whole chain from its own inputs, as the
  rays are made.

For each op that rounds apart it also prints the share of lanes on which
the CPU's float32 result is the float64 result rounded to float32, on
each device: computing the op in float64 would change the CPU's bits on
the rest. Then the rays once more with the camera's constants (the
half-angle ``tan``, the basis, the film corners) taken from the CPU, the
per-lane ops on the card. The last line of stdout is one JSON object of
these shares. Prints the card's name and power limit.
"""
import json
import math
import sys

import torch

from raytracingpbr_tpu_torch import bench
from raytracingpbr_tpu_torch.core import rng
from raytracingpbr_tpu_torch.core.math import normalize, radians
from raytracingpbr_tpu_torch.models import cornell
from raytracingpbr_tpu_torch.ops import camera

CFG = cornell.full_config()
# the camera's constants: one value a camera, computed before any lane
CONSTANTS = ("theta", "half_height", "half_width", "z", "x", "y",
             "lens_radius", "hwfx", "hhfy", "lower_left")
# (name, what it makes, the function of the values so far, its rounding
# compared against float64's)
OPS = (
    ("uniform4", lambda e: {"u": torch.stack(rng.uniform4(
        e["pid"], 0, 1, CFG.seed))}, False),
    ("pixel_uv", lambda e: {"uv": camera.pixel_uv(
        e["pid"], CFG.width, CFG.height, e["u"][0], e["u"][1])}, False),
    ("radians", lambda e: {"theta": radians(e["vfov"])}, False),
    ("tan", lambda e: {"half_height": torch.tan(e["theta"] * 0.5)}, True),
    ("half_width", lambda e: {"half_width": e["aspect"] * e["half_height"]},
     False),
    ("normalize z", lambda e: {"z": normalize(e["lookfrom"] - e["lookat"])},
     True),
    ("cross, normalize x", lambda e: {"x": normalize(torch.linalg.cross(
        e["vup"], e["z"]))}, True),
    ("cross y", lambda e: {"y": torch.linalg.cross(e["z"], e["x"])}, False),
    ("lens radius", lambda e: {"lens_radius": e["aperture"] * 0.5}, False),
    ("disk angle", lambda e: {"a": e["u"][3] * (2.0 * math.pi)}, False),
    ("sqrt", lambda e: {"r": torch.sqrt(e["u"][2])}, True),
    ("sin", lambda e: {"sin": torch.sin(e["a"])}, True),
    ("cos", lambda e: {"cos": torch.cos(e["a"])}, True),
    ("disk", lambda e: {"rud": e["lens_radius"] * torch.stack(
        [e["r"] * e["sin"], e["r"] * e["cos"]], dim=-1)}, False),
    ("offset", lambda e: {"offset": e["rud"][:, :1] * e["x"]
                          + e["rud"][:, 1:2] * e["y"]}, False),
    ("film corners", lambda e: (lambda hwfx, hhfy: {
        "hwfx": hwfx, "hhfy": hhfy,
        "lower_left": e["lookfrom"] - hwfx - hhfy - e["focus"] * e["z"]})(
        e["half_width"] * e["focus"] * e["x"],
        e["half_height"] * e["focus"] * e["y"]), False),
    ("origin", lambda e: {"ro": e["lookfrom"] + e["offset"]}, False),
    ("film point", lambda e: {"po": e["lower_left"]
                              + e["uv"][:, :1] * 2.0 * e["hwfx"]
                              + e["uv"][:, 1:2] * 2.0 * e["hhfy"]}, False),
    ("difference", lambda e: {"v": e["po"] - e["ro"]}, False),
    ("vector_norm", lambda e: {"norm": torch.linalg.vector_norm(
        e["v"], dim=-1, keepdim=True)}, True),
    ("divide", lambda e: {"rd": e["v"] / e["norm"]}, False),
)


def inputs(dev):
    cam = cornell.full_camera(dev)
    e = {k: getattr(cam, k) for k in ("lookfrom", "lookat", "vup", "vfov",
                                      "aspect", "aperture", "focus")}
    e["pid"] = torch.arange(CFG.num_pixels, dtype=torch.int64, device=dev)
    return e


def run_chain(dev, given=None):
    """Every op in order on ``dev``; ``given``: values that replace the
    op's own output (moved to ``dev``)."""
    e = inputs(dev)
    for _, fn, _ in OPS:
        out = fn(e)
        if given is not None:
            out = {k: given[k].to(dev) if k in given else v
                   for k, v in out.items()}
        e.update(out)
    return e


def lanes(t):
    """The tensor as (lanes, values): a row a lane, one row a constant."""
    n = CFG.num_pixels
    if t.dim() == 2 and t.shape == (4, n):  # uniform4's
        return t.T
    return t.reshape(n, -1) if t.dim() and t.shape[0] == n else t.reshape(
        1, -1)


def share(a, b):
    """Share of lanes whose values are all bit-equal, and the largest
    difference."""
    a, b = lanes(a.cpu()), lanes(b.cpu())
    return (float((a == b).all(dim=-1).double().mean()),
            float((a.double() - b.double()).abs().max()))


def in_float64(fn, e):
    """``fn`` on ``e``'s float32 values cast to float64, its outputs rounded
    back to float32."""
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in e.items()}
    return {k: v.float() for k, v in fn(wide).items()}


def probe(dev):
    """The shares of ``dev`` against the CPU, as the module's docstring
    says. Returns them."""
    cpu = run_chain(torch.device("cpu"))
    card = run_chain(dev)
    for d, e in ((torch.device("cpu"), cpu), (dev, card)):
        o, r = bench.utilization_rays(CFG, cornell.full_camera(d))
        if not (torch.equal(o, e["ro"]) and torch.equal(r, e["rd"])):
            raise AssertionError(f"the chain is not get_ray on {d}")
    result = {"ops": {}}
    for name, fn, wide in OPS:
        got = fn({k: v.to(dev) for k, v in cpu.items()})
        row = {}
        for k, v in got.items():
            own, own_diff = share(v, cpu[k])
            chained, chained_diff = share(card[k], cpu[k])
            row[k] = dict(own=own, own_diff=own_diff, chained=chained,
                          chained_diff=chained_diff)
        if wide:
            w_cpu = in_float64(fn, cpu)
            w_card = in_float64(fn, {k: v.to(dev) for k, v in cpu.items()})
            for k in got:
                row[k]["cpu_is_float64_rounded"] = share(cpu[k], w_cpu[k])[0]
                row[k]["card_is_float64_rounded"] = share(
                    got[k], w_cpu[k])[0]
                row[k]["float64_rounded_card_vs_cpu"] = share(
                    w_card[k], w_cpu[k])[0]
        result["ops"][name] = row
        for k, v in row.items():
            print(f"{name:>20} -> {k:<12} " + ", ".join(
                f"{f} {x:.6f}" if "diff" not in f else f"{f} {x:.3e}"
                for f, x in v.items()), file=sys.stderr)
    host = run_chain(dev, {k: cpu[k] for k in CONSTANTS})
    result["constants_from_the_cpu"] = {k: share(host[k], cpu[k])[0]
                                        for k in ("ro", "rd")}
    result["rays"] = {k: share(card[k], cpu[k])[0] for k in ("ro", "rd")}
    print(f"rays chained: origins {result['rays']['ro']:.6f}, directions "
          f"{result['rays']['rd']:.6f} bit-equal; with the camera's "
          f"constants from the CPU: origins "
          f"{result['constants_from_the_cpu']['ro']:.6f}, directions "
          f"{result['constants_from_the_cpu']['rd']:.6f}", file=sys.stderr)
    return result


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe compares the card "
                         "with the CPU")
    result = probe(torch.device("cuda"))
    print(bench.card_line(), file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main(sys.argv[1:])
