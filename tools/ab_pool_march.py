#!/usr/bin/env python3
"""Times the bunny march kernels K1c and K1d of this tree (the persistent
lane pool, ``raytracingpbr_tpu_torch/csrc/march_pool.cuh``) against those of
another commit, in turns on the same inputs on one card.

    PYTHONPATH=. python3 tools/ab_pool_march.py PREV_DIR

PREV_DIR holds an unpacked ``git archive`` of the other commit, in a
directory that ``.gitignore`` lists, such as ``build/prev``. Two kinds of
tree are taken, by the C entry of their ``rt_march``:
- the commit before the pool (``78e40c0``: K1c a thread a lane, K1d a warp
  in lock step), whose entry has no ``next_lane`` and ``counts``;
- a commit with the pool's entry (an earlier pool, such as the parent of a
  change to ``march_pool.cuh``), called as this tree's wrapper calls it.
A tree with another entry is refused. Its ``csrc/march.cu`` and
``csrc/march_mxu.cu`` are built with this tree's nvcc flags, and both trees
march on this tree's packs of the scene, whose layout those commits share.
``-Xptxas -v``'s registers, stack frame and spills of the bunny paths'
pool instance (CONSTANT omega, RELATIVE hit, no bound) are printed for
both trees.

Inputs, made as ``chip_smoke.py`` makes them:
- the four budget-32 march calls of one frame of the bunny glass path at
  1920x1080 (scene animated to frame 12) and of the metal path at
  3840x2160 with ``bunny_mxu`` off (K1c) and on (K1d), each recorded after
  4 frames from a fresh state;
- the glass mixed state after 3 steps and the metal state after 16 steps
  (``chip_smoke.py`` phase 5), with K1c and with K1d.

On each input, K1c's eight outputs must be bit-equal between the trees
(K1d's differing values are counted), then the two are timed new, prev,
prev, new after a warm-up, medians of 5 CUDA-event readings each. Prints a
line an input and, as the last line, a JSON summary with the card's name
and power limit.
"""
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from chip_smoke import (CSRC, bunny_config, capture_frame, card_line,
                        in_turns, log, metal_config, mixed_state,
                        ptxas_summary)
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.kernels import build, march_kernel
from raytracingpbr_tpu_torch.models import bunny
from raytracingpbr_tpu_torch.ops import march
from raytracingpbr_tpu_torch.ops.integrator import render_frame

REPS = 5
# the C entry of the commit before the pool: the eighth output, the block
# and the stream, with no pointer between them
PREV_ENTRY = re.compile(r"int\s*\*\s*done_out,\s*int\s+block,\s*\\?\s*"
                        r"void\s*\*\s*stream")


def pool_ptxas(report: str) -> str:
    """Registers, stack frame and spills of the bunny paths' pool instance
    (``pool_kernel<0, 1, false, ...>``) and of any function it calls out
    of line, from a library's ``-Xptxas -v`` report."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        keep = name and ("pool_kernelILi0ELi1ELb0E" in name
                         or "nearest_non_finite" in name)
        if keep and ("stack frame" in line or "Used" in line):
            out.append(f"{name[:48]}: {' '.join(line.split())}")
    return "; ".join(dict.fromkeys(out)) or "no pool instance found"


class PrevKernels:
    """K1c and K1d of another commit, built into ``build/.../prev``. For
    timing beside this tree's only: no render path calls them and they are
    counted nowhere."""

    SOURCES = {"k1c": "march", "k1d": "march_mxu"}

    def __init__(self, root):
        self.csrc = Path(root) / CSRC
        entry = (self.csrc / "march_common.cuh").read_text()
        self.pooled = "int *next_lane, unsigned long long *counts" in (
            " ".join(entry.split()))
        if not (self.pooled or ("next_lane" not in entry
                                and PREV_ENTRY.search(entry))):
            raise SystemExit(f"{self.csrc}: its rt_march is neither the "
                             f"pool's entry nor that of the commit before "
                             f"the pool")
        self.out = build.BUILD_DIR / "prev"
        self.jobs, self.libs = {}, {}

    def start(self):
        self.out.mkdir(parents=True, exist_ok=True)
        for name in self.SOURCES.values():
            lib = self.out / f"lib{name}.so"
            log_f = open(f"{lib}.log", "w")
            self.jobs[name] = (lib, log_f, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(self.csrc / f"{name}.cu")], stdout=log_f,
                stderr=subprocess.STDOUT))

    def wait(self):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, (lib, log_f, proc) in self.jobs.items():
            rc = proc.wait()
            log_f.close()
            report = Path(f"{lib}.log").read_text()
            if rc != 0:
                raise RuntimeError(f"prev {name}.cu: nvcc failed ({rc}):\n"
                                   + report)
            cdll = ctypes.CDLL(str(lib))
            if self.pooled:
                march_kernel.declare(cdll, name)
            else:
                cdll.rt_march.argtypes = ([p, p, p, i, f, p, p, p, p, p, p,
                                           p, f, f, f, f, f, f, i, i, i, i,
                                           i] + [p] * 8 + [i, p])
                cdll.rt_march.restype = i
            self.libs[name] = cdll
            log(f"[ab] ptxas prev {name}.cu: {ptxas_summary(report)}; "
                f"{pool_ptxas(report)}")
            log(f"[ab] ptxas this {name}.cu: "
                f"{pool_ptxas(build.ptxas_report(name))}")

    def march(self, scene, o, d, cfg, active=None, init=None):
        kind = march_kernel.variant(scene, cfg)
        lib = self.libs[self.SOURCES[kind]]
        bound2, params, pack = march_kernel.scene_packs(scene, kind, cfg)
        n = o.shape[0]
        f32 = dict(dtype=torch.float32, device=o.device)
        i32 = dict(dtype=torch.int32, device=o.device)
        t, w, s, dd = (torch.empty((n,), **f32) for _ in range(4))
        idx, fin, done = (torch.empty((n,), **i32) for _ in range(3))
        hit = torch.empty((n,), dtype=torch.bool, device=o.device)
        ptr = lambda x: None if x is None else x.data_ptr()
        inits = (None,) * 4 if init is None else init
        next_lane = torch.zeros((1,), **i32) if self.pooled else None
        pool = ((next_lane.data_ptr(), None, march_kernel.POOL_SLOTS)
                if self.pooled else (march_kernel.BLOCK,))
        rc = lib.rt_march(
            ptr(params), ptr(scene.type_ids), ptr(pack), scene.num_objects,
            scene.box_round, ptr(o), ptr(d), ptr(active),
            *(ptr(v) for v in inits), cfg.march_t0, cfg.omega,
            cfg.hit_precision, cfg.max_dis, cfg.pixel_radius, 1.0 + 1e-6,
            march_kernel._POLICY[cfg.omega_policy],
            march_kernel._CRIT[cfg.hit_criterion], int(bound2 is not None),
            cfg.max_raymarch, n, ptr(t), ptr(idx), ptr(hit), ptr(fin),
            ptr(w), ptr(s), ptr(dd), ptr(done), *pool,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"prev {kind} launch failed: CUDA error {rc}")
        return march.ResumableResult(t, idx, hit, fin, w, s, dd, done)


def frame_calls(scene, env, cam, cfg, dev):
    """The march calls of the fifth frame from a fresh state."""
    state = make_frame_state(cfg.num_pixels, device=dev)
    for _ in range(4):
        _, state = render_frame(scene, env, cam, state, cfg)
    calls, _ = capture_frame(scene, env, cam, cfg, state)
    torch.cuda.synchronize()
    return calls


def state_call(scene, env, cam, cfg, steps):
    """A budget-32 call on the split march's state after ``steps`` steps."""
    o, d, init, _ = mixed_state(scene, env, cam, cfg, steps=steps)
    return (o, d, None, init, cfg.replace(max_raymarch=cfg.march_split))


def ab(label, scene, calls, mxu, prev):
    """Each call of ``calls`` through both trees: outputs compared, times
    in turns. Returns the sums."""
    tot = dict(ms=0.0, prev_ms=0.0, values_apart=0, calls=len(calls))
    for j, (o, d, act, init, c) in enumerate(calls):
        cfg = c.replace(bunny_mxu=mxu)
        new = march.ResumableResult(*march_kernel.march_resumable_cuda(
            scene, o, d, cfg, active=act, init=init))
        old = prev.march(scene, o, d, cfg, act, init)
        apart = sum(int((x != y).sum()) for x, y in zip(new, old))
        if apart and not mxu:
            raise AssertionError(f"{label} call {j}: K1c differs from the "
                                 f"previous K1c on {apart} values")
        ms, prev_ms, meds = in_turns(
            lambda: march_kernel.march_resumable_cuda(
                scene, o, d, cfg, active=act, init=init),
            lambda: prev.march(scene, o, d, cfg, act, init), REPS, REPS)
        log(f"[ab] {label} call {j}: this {ms:.4f} ms, prev {prev_ms:.4f} "
            f"ms (n p p n: {', '.join(f'{v:.4f}' for v in meds)}); "
            f"{o.shape[0]} lanes; outputs "
            f"{'bit-equal' if not apart else f'{apart} values apart'}")
        tot["ms"] += ms
        tot["prev_ms"] += prev_ms
        tot["values_apart"] += apart
    change = 100 * (tot["ms"] / tot["prev_ms"] - 1)
    log(f"[ab] {label}, sum of {len(calls)}: this {tot['ms']:.4f} ms, prev "
        f"{tot['prev_ms']:.4f} ms ({change:+.1f}%)")
    return tot


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the comparison needs the card")
    dev = torch.device("cuda", 0)
    card = card_line()
    log("[ab] card:", card)
    prev = PrevKernels(sys.argv[1])
    t0 = time.perf_counter()
    prev.start()
    build.build_all()
    march_kernel.load("march")
    march_kernel.load("march_mxu")
    prev.wait()
    log(f"[ab] built both trees' K1c and K1d in "
        f"{time.perf_counter() - t0:.2f} s")

    env = bunny.glass_environment(device=dev)
    gcfg = bunny_config()
    glass = bunny.glass_scene(dev)
    anim = bunny.animated_scene(glass, torch.tensor(12.0, device=dev))
    gcam = bunny.camera(gcfg.width / gcfg.height, dev)
    mcfg = metal_config()
    metal = bunny.metal_scene(dev)
    mcam = bunny.camera(16 / 9, dev)
    out = {}
    gcalls = frame_calls(anim, env, gcam, gcfg, dev)
    out["glass frame, K1c"] = ab("glass frame, K1c", anim, gcalls, False,
                                 prev)
    out["glass frame, K1d"] = ab("glass frame, K1d", anim, gcalls, True,
                                 prev)
    del gcalls
    gstate = [state_call(glass, env, gcam, gcfg, 3)]
    out["glass state, K1c"] = ab("glass state, K1c", glass, gstate, False,
                                 prev)
    out["glass state, K1d"] = ab("glass state, K1d", glass, gstate, True,
                                 prev)
    del gstate
    for mxu, name in ((False, "K1c"), (True, "K1d")):
        calls = frame_calls(metal, env, mcam, mcfg.replace(bunny_mxu=mxu),
                            dev)
        out[f"metal frame, {name}"] = ab(f"metal frame, {name}", metal,
                                         calls, mxu, prev)
        del calls
    mstate = [state_call(metal, env, mcam, mcfg, 16)]
    for mxu, name in ((False, "K1c"), (True, "K1d")):
        out[f"metal state, {name}"] = ab(f"metal state, {name}", metal,
                                         mstate, mxu, prev)
    print(json.dumps({"card": card, "reps": REPS, "ab": out}), flush=True)


if __name__ == "__main__":
    main()
