#!/usr/bin/env python3
"""Times the analytic march kernels K1a and K1b of this tree against those
of another commit, in turns on the same inputs on one card, and counts the
SASS instructions of their object loops.

    PYTHONPATH=. python3 tools/ab_march.py PREV_DIR [--out DIR] [--sweep]
    PYTHONPATH=. python3 tools/ab_march.py --listing DIR/new.sass ...

PREV_DIR holds an unpacked ``git archive ea88f6d``: the last commit whose
K1a and K1b run the object loop with a type switch on every object. Put it
in a directory that ``.gitignore`` lists, such as ``build/prev_groups``. Its
``csrc/march.cu`` is built with this tree's nvcc flags and called through
that commit's C entry (``rt_march`` with the pool's ``next_lane`` and
``counts``), on that commit's packing of the scene
(``march_kernel.pack_scene`` and the shape types). A tree whose entry has
other arguments is refused.

Inputs, made as ``chip_smoke.py`` makes them:
- the four budget-32 march calls of one frame (the fifth from a fresh
  state) of the Cornell path at 480x480 (K1a), the tokyo path at 2880x1620
  and the engine path at 768x432 (K1b);
- ``chip_smoke.py``'s phase 2 and 5 states: the Cornell primaries at
  480x480 and the Cornell mixed state after 3 steps (K1a), scene_demo's
  768x432 primaries (K1b).

On each input the eight outputs of the two trees must be bit-equal; then
both are timed new, prev, prev, new after a warm-up, each the median of 3
readings of ``chip_smoke.device_ms`` (calls back to back behind a sleep:
the kernel's own time).

SASS: ``cuobjdump -sass`` of both libraries; for each K1a/K1b instance the
paths are named, every innermost loop of the kernel is split into its
paths from head to back branch, and each path that marches an object
(it reads the staged scene from shared memory) is classified by shape and
transform (:func:`classify`) and counted. The listings go to ``DIR`` (by
default ``build/ab_march``).

``--sweep`` also times this tree's kernel on the frames' calls at each
block size of :data:`BLOCKS` (the launch's argument) and, at blocks of
256, with each ``__launch_bounds__`` minimum of blocks an SM of
:data:`MIN_BLOCKS` (a build of ``march.cu`` with
``-DRT_ANALYTIC_MAX_THREADS=256 -DRT_ANALYTIC_MIN_BLOCKS=N`` under
``DIR``) and, with ``--also TREE...``,
another tree's ``march.cu`` that keeps this tree's entry and packs (a
design variant); each setting must give this tree's outputs bit for bit.

Prints a line an input and, as the last line, a JSON summary with the
card's name and power limit.
"""
import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

from chip_smoke import (CSRC, card_line, capture_frame, device_ms, k1b_paths,
                        log, main_config, mixed_state, primaries,
                        ptxas_summary)
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.kernels import build, march_kernel
from raytracingpbr_tpu_torch.models import cornell, demo
from raytracingpbr_tpu_torch.ops import march
from raytracingpbr_tpu_torch.ops import scene as scenelib
from raytracingpbr_tpu_torch.ops.integrator import render_frame

READINGS = 3
BLOCKS = (128, 256, 512)
MIN_BLOCKS = (1, 4, 5, 6)
# the K1a/K1b instances whose object loops are counted: (policy, crit,
# bound) of the Cornell, tokyo and engine paths
INSTANCES = {"k1a cornell": (0, 0, 0), "k1b tokyo": (2, 1, 0),
             "k1b engine": (1, 2, 0)}


def median_device_ms(fn):
    return statistics.median(device_ms(fn) for _ in range(READINGS))


class PrevMarch:
    """K1a and K1b of another commit, built into ``build/.../prev_march``.
    For timing beside this tree's only: no render path calls them and they
    are counted nowhere."""

    def __init__(self, root):
        self.src = Path(root) / CSRC / "march.cu"
        entry = (Path(root) / CSRC / "march_common.cuh").read_text()
        if "int *next_lane, unsigned long long *counts, int block" not in (
                " ".join(entry.split())):
            raise SystemExit(f"{self.src}: its rt_march is not the entry of "
                             f"ea88f6d")
        self.lib_path = build.BUILD_DIR / "prev_march" / "libmarch.so"
        self.packs = {}

    def start(self):
        self.lib_path.parent.mkdir(parents=True, exist_ok=True)
        self.log = open(f"{self.lib_path}.log", "w")
        self.proc = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(self.lib_path),
             str(self.src)], stdout=self.log, stderr=subprocess.STDOUT)

    def wait(self):
        rc = self.proc.wait()
        self.log.close()
        report = Path(f"{self.lib_path}.log").read_text()
        if rc != 0:
            raise RuntimeError(f"prev march.cu: nvcc failed ({rc}):\n{report}")
        self.lib = march_kernel.declare(ctypes.CDLL(str(self.lib_path)))
        log(f"[ab] ptxas prev march.cu: {ptxas_summary(report)}")

    def march(self, scene, o, d, cfg, active=None, init=None):
        key = (id(scene), scenelib.has_escape_bound(scene, cfg))
        if key not in self.packs:
            bound2 = scenelib.escape_bound2(scene, cfg)
            self.packs[key] = (scene, bound2, march_kernel.pack_scene(
                scene, bound2).contiguous())
        _, bound2, params = self.packs[key]
        n = o.shape[0]
        f32 = dict(dtype=torch.float32, device=o.device)
        i32 = dict(dtype=torch.int32, device=o.device)
        t, w, s, dd = (torch.empty((n,), **f32) for _ in range(4))
        idx, fin, done = (torch.empty((n,), **i32) for _ in range(3))
        hit = torch.empty((n,), dtype=torch.bool, device=o.device)
        ptr = lambda x: None if x is None else x.data_ptr()
        inits = (None,) * 4 if init is None else init
        rc = self.lib.rt_march(
            ptr(params), ptr(scene.type_ids), None, scene.num_objects,
            scene.box_round, ptr(o), ptr(d), ptr(active),
            *(ptr(v) for v in inits), cfg.march_t0, cfg.omega,
            cfg.hit_precision, cfg.max_dis, cfg.pixel_radius, 1.0 + 1e-6,
            march_kernel._POLICY[cfg.omega_policy],
            march_kernel._CRIT[cfg.hit_criterion], int(bound2 is not None),
            cfg.max_raymarch, n, ptr(t), ptr(idx), ptr(hit), ptr(fin),
            ptr(w), ptr(s), ptr(dd), ptr(done), None, None,
            march_kernel.BLOCK, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"prev march launch failed: CUDA error {rc}")
        return march.ResumableResult(t, idx, hit, fin, w, s, dd, done)


def frame_calls(scene, env, cam, cfg, dev):
    """The march calls of the fifth frame from a fresh state."""
    state = make_frame_state(cfg.num_pixels, device=dev)
    for _ in range(4):
        _, state = render_frame(scene, env, cam, state, cfg)
    calls, _ = capture_frame(scene, env, cam, cfg, state)
    torch.cuda.synchronize()
    return calls


def inputs(dev):
    """{label: (scene, [(origin, direction, active, init, cfg)])}."""
    cfg = main_config()
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    out = {"cornell frame": (scene, frame_calls(scene, env, cam, cfg, dev))}
    for label, (sc, e, c, f) in k1b_paths(dev).items():
        out[f"{label.split()[0]} frame"] = (sc, frame_calls(sc, e, c, f,
                                                            dev))
    mcfg = cfg.replace(max_raymarch=cfg.march_split)
    o, d = primaries(cfg, cam)
    out["cornell primaries"] = (scene, [(o, d, None, None, mcfg)])
    mo, md, minit, _ = mixed_state(scene, env, cam, cfg)
    out["cornell mixed state"] = (scene, [(mo, md, None, minit, mcfg)])
    dcfg = demo.scene_demo_config().replace(resolution=(768, 432),
                                            max_raymarch=32)
    sd = demo.scene_demo_scene(dev)
    o, d = primaries(dcfg, demo.engine_camera(dev))
    out["scene_demo primaries"] = (sd, [(o, d, None, None, dcfg)])
    return out


def ab(label, scene, calls, prev):
    """Each call through both trees: outputs compared, times in turns.
    Returns the sums."""
    tot = dict(ms=0.0, prev_ms=0.0, calls=len(calls), prev_fault_lanes=0)
    for j, (o, d, act, init, cfg) in enumerate(calls):
        kind = march_kernel.variant(scene, cfg)
        new = march.ResumableResult(*march_kernel.march_resumable_cuda(
            scene, o, d, cfg, active=act, init=init))
        old = prev.march(scene, o, d, cfg, act, init)
        plain = march.march_resumable_plain(scene, o, d, cfg, act, init)
        if any(bool((x != y).any()) for x, y in zip(new, plain)):
            raise AssertionError(f"{label} call {j}: this tree differs from "
                                 f"the plain march")
        # ea88f6d's fault: on a point with a NaN or an infinite coordinate
        # its box SDF (fmaxf) and sphere (sqrtf) part from the plain march
        lanes = torch.zeros_like(new.hit)
        for x, y in zip(new, old):
            lanes |= x != y
        finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
        if init is not None:
            finite &= torch.isfinite(init[0])
        if bool((lanes & finite).any()):
            raise AssertionError(f"{label} call {j}: the trees differ on "
                                 f"{int((lanes & finite).sum())} lanes of "
                                 f"finite rays")
        tot["prev_fault_lanes"] += int(lanes.sum())
        run_new = lambda: march_kernel.march_resumable_cuda(
            scene, o, d, cfg, active=act, init=init)
        run_prev = lambda: prev.march(scene, o, d, cfg, act, init)
        meds = [median_device_ms(run_new), median_device_ms(run_prev),
                median_device_ms(run_prev), median_device_ms(run_new)]
        ms, prev_ms = (meds[0] + meds[3]) / 2, (meds[1] + meds[2]) / 2
        log(f"[ab] {label} call {j} ({kind.upper()}): new {ms:.4f} ms, prev "
            f"{prev_ms:.4f} ms (n p p n: "
            f"{', '.join(f'{v:.4f}' for v in meds)}); {o.shape[0]} lanes; "
            f"new bit-equal to the plain march, prev to new but on "
            f"{int(lanes.sum())} lanes of non-finite rays")
        tot["ms"] += ms
        tot["prev_ms"] += prev_ms
    change = 100 * (tot["ms"] / tot["prev_ms"] - 1)
    log(f"[ab] {label}, sum of {len(calls)}: new {tot['ms']:.4f} ms, prev "
        f"{tot['prev_ms']:.4f} ms ({change:+.1f}%)")
    tot["change_pct"] = change
    return tot


# --- SASS ------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`?\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")
_FUNC = re.compile(r"Function : (\S+)")
# opcodes whose counts tell the paths apart
_KEYS = ("LDS", "MUFU.RSQ", "FMNMX", "FMUL", "FADD", "FSEL", "SEL")


def ptxas_instances(report: str) -> dict:
    """{instance of :data:`INSTANCES`: (registers, spill store bytes)} from
    a library's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
        if name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split()[-1])
            out.setdefault(name, [0, 0])[1] = spill
        if name and "Used" in line and "registers" in line:
            out.setdefault(name, [0, 0])[0] = int(
                line.split("Used")[1].split()[0])
    return {label: tuple(v) for label, (p, c, b) in INSTANCES.items()
            for n, v in out.items()
            if "march_kernel" in n and f"ILi{p}ELi{c}ELb{b}E" in n}


def sass_functions(lib: Path) -> dict:
    """{mangled name: [(address, predicated, opcode, operands)]} of every
    K1a/K1b instance (``march_kernel``) in the library."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name, body, labels = {}, None, [], {}
    pending = []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1) if "march_kernel" in m.group(1) else None
            if name:
                funcs[name] = body = []
                labels[name] = {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            body.append((addr, bool(m.group(2)), m.group(3),
                         m.group(4).strip()))
    return {k: (v, labels[k]) for k, v in funcs.items()}


def _target(operands, labels):
    m = _TARGET.search(operands)
    if not m:
        return None
    return labels[m.group(1)] if m.group(1) else int(m.group(2), 16)


def loop_paths(insns, labels, limit=20000, longest=250):
    """Every innermost loop's paths from its head to its back branch (a
    conditional branch to an earlier address): [(head address, [path as a
    list of opcodes])]. A path may leave the
    loop's address range and come back (the compiler places cold switch
    cases after the loop); it is dropped where it revisits an instruction,
    exits, enters another innermost loop or runs past ``longest``."""
    at = {a: k for k, (a, _, _, _) in enumerate(insns)}
    loops = []  # a conditional branch back (a cold block jumps back always)
    for k, (a, pred, op, ops) in enumerate(insns):
        if op.startswith("BRA") and pred:
            t = _target(ops, labels)
            if t is not None and t <= a:
                loops.append((at[t], k))
    inner = [(h, e) for h, e in loops
             if not any(h <= h2 and e2 <= e and (h2, e2) != (h, e)
                        for h2, e2 in loops)]
    out = []
    for h, e in inner:
        others = [(h2, e2) for h2, e2 in inner if (h2, e2) != (h, e)]
        paths, stack = [], [(h, ())]
        while stack and len(paths) < limit:
            k, path = stack.pop()
            if (k in path or len(path) > longest
                    or any(h2 <= k <= e2 for h2, e2 in others)):
                continue
            a, pred, op, ops = insns[k]
            path = path + (k,)
            if k == e:
                paths.append([insns[j][2] for j in path])
                continue
            if op.startswith(("EXIT", "RET")) and not pred:
                continue
            nxt = []
            if op.startswith("BRA"):
                t = _target(ops, labels)
                if t in at:
                    nxt.append(at[t])
                if pred:
                    nxt.append(k + 1)
            elif k + 1 < len(insns):
                nxt.append(k + 1)
            stack.extend((n, path) for n in nxt)
        out.append((insns[h][0], paths))
    return out


def signature(path) -> dict:
    c = collections.Counter(path)
    sig = {key: sum(v for op, v in c.items()
                    if op == key or op.startswith(key + "."))
           for key in _KEYS}
    sig["MUFU.RSQ"] = c["MUFU.RSQ"]
    return sig


def classify(sig) -> str:
    """Shape and transform of an object path from its opcode counts: the
    SDF's square roots (one MUFU.RSQ each: sphere, box and cone one, the
    cylinder two, the plane none) and maxima (the box's six), and the
    matrix's nine products."""
    rsq, mnmx, fmul = sig["MUFU.RSQ"], sig["FMNMX"], sig["FMUL"]
    if rsq == 0:
        shape, own = "plane", 0
    elif rsq == 2:
        shape, own = "cylinder", 4
    elif mnmx >= 5:
        shape, own = "box", 3
    elif mnmx >= 1:
        shape, own = "cone", 3
    else:
        shape, own = "sphere", 3
    return f"{shape}, {'matrix' if fmul - own >= 9 else 'permutation'}"


_DUMP_INSN = re.compile(r"^0x([0-9a-f]+) (@ )?(\S+) ?(.*)$")


def read_listing(path: Path) -> dict:
    """The functions of a listing written by :func:`sass_report`, as
    :func:`sass_functions` returns them."""
    funcs, name, pending = {}, None, []
    for line in path.read_text().splitlines():
        if line.startswith("== "):
            name = line[3:]
            funcs[name] = ([], {})
        elif line.endswith(":"):
            pending.append(line[:-1])
        elif name is not None:
            m = _DUMP_INSN.match(line)
            addr = int(m.group(1), 16)
            for lab in pending:
                funcs[name][1][lab] = addr
            pending = []
            funcs[name][0].append((addr, bool(m.group(2)), m.group(3),
                                   m.group(4)))
    return funcs


def sass_report(funcs: dict, tag: str, out_dir: Path) -> dict:
    """{instance: {path class: fewest instructions}} for each instance of
    :data:`INSTANCES` among ``funcs`` (:func:`sass_functions`), with the
    listing and the paths written to ``out_dir``."""
    with open(out_dir / f"{tag}.sass", "w") as f:
        for name, (insns, labels) in funcs.items():
            f.write(f"== {name}\n")
            names = {v: k for k, v in labels.items()}
            for a, pred, op, ops in insns:
                if a in names:
                    f.write(f"{names[a]}:\n")
                f.write(f"{a:#06x} {'@ ' if pred else ''}{op} {ops}\n")
    report = {}
    with open(out_dir / f"{tag}_loops.txt", "w") as f:
        for label, (p, c, b) in INSTANCES.items():
            suffix = f"ILi{p}ELi{c}ELb{b}E"
            names = [n for n in funcs if suffix in n]
            if len(names) != 1:
                raise RuntimeError(f"{tag}: {len(names)} functions match "
                                   f"{suffix}")
            insns, labels = funcs[names[0]]
            f.write(f"== {label}: {names[0]}, {len(insns)} instructions\n")
            best = {}
            for head, paths in loop_paths(insns, labels):
                seen = set()
                for path in paths:
                    sig = signature(path)
                    slow = any(op.startswith("CALL") for op in path)
                    if (len(path), slow, tuple(sig.values())) in seen:
                        continue
                    seen.add((len(path), slow, tuple(sig.values())))
                    cls = classify(sig) if sig["LDS"] else "staging"
                    f.write(f"loop {head:#x}: {len(path)} instructions, "
                            f"{cls}{' (slow sqrt)' if slow else ''} {sig}\n")
                    if cls != "staging" and not slow:
                        best[cls] = min(best.get(cls, len(path)), len(path))
            report[label] = best
            f.write(f"fewest instructions per object-trip: {best}\n")
    log(f"[sass] {tag}: " + "; ".join(
        f"{k}: " + ", ".join(f"{c} {n}" for c, n in sorted(v.items()))
        for k, v in report.items()))
    return report


# --- sweep -----------------------------------------------------------------


def sweep(frames, out_dir: Path, also=()) -> dict:
    """This tree's kernel on the frames' calls at each block size of
    :data:`BLOCKS`, with each ``__launch_bounds__`` minimum of
    :data:`MIN_BLOCKS` and, for each tree in ``also``, its ``march.cu``
    built with this tree's flags (same entry and packs): {setting: {frame:
    ms summed over its calls}}. Each setting's outputs must be bit-equal to
    this tree's; the default setting runs first and last."""
    builds = [(f"block 256, min blocks {mb}",
               ["-DRT_ANALYTIC_MAX_THREADS=256",
                f"-DRT_ANALYTIC_MIN_BLOCKS={mb}"], build.CSRC / "march.cu")
              for mb in MIN_BLOCKS]
    builds += [(f"tree {Path(t).name}", [], Path(t) / CSRC / "march.cu")
               for t in also]
    jobs = []
    for k, (name, flags, src) in enumerate(builds):
        lib = out_dir / f"libmarch_sweep{k}.so"
        with open(f"{lib}.log", "w") as log_f:
            jobs.append((name, lib, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o",
                 str(lib), str(src)], stdout=log_f,
                stderr=subprocess.STDOUT)))
    default = march_kernel.ANALYTIC_BLOCK
    settings = {f"block {b}": (b, None) for b in BLOCKS}
    for name, lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + Path(f"{lib}.log").read_text())
        settings[name] = (default, lib)
        log(f"[sweep] {name}: (registers, spill bytes) "
            f"{ptxas_instances(Path(f'{lib}.log').read_text())}")
    settings[f"block {default} again"] = (default, None)
    want = {label: [march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=act, init=init)
        for o, d, act, init, cfg in calls]
        for label, (scene, calls) in frames.items()}
    out = {}
    default_lib = march_kernel.load("march")
    try:
        for name, (block, lib) in settings.items():
            march_kernel.ANALYTIC_BLOCK = block
            march_kernel._libs["march"] = (
                default_lib if lib is None else
                march_kernel.declare(ctypes.CDLL(str(lib))))
            out[name] = {}
            for label, (scene, calls) in frames.items():
                total = 0.0
                for (o, d, act, init, cfg), ref in zip(calls, want[label]):
                    run = lambda: march_kernel.march_resumable_cuda(
                        scene, o, d, cfg, active=act, init=init)
                    if any(bool((x != y).any()) for x, y in zip(run(), ref)):
                        raise AssertionError(f"{name}: {label} differs")
                    total += median_device_ms(run)
                out[name][label] = total
            log(f"[sweep] {name}: " + "; ".join(
                f"{k} {v:.4f} ms" for k, v in out[name].items())
                + "; bit-equal")
    finally:
        march_kernel.ANALYTIC_BLOCK = default
        march_kernel._libs["march"] = default_lib
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("prev", nargs="?")
    ap.add_argument("--out", default=str(build.BUILD_DIR.parent / "ab_march"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--also", nargs="*", default=(),
                    help="with --sweep: trees whose march.cu (this tree's "
                         "entry and packs) is timed beside this one")
    ap.add_argument("--listing", nargs="+", type=Path,
                    help="count the object loops of listings an earlier run "
                         "wrote (NAME.sass) and stop; needs no card")
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.listing:
        print(json.dumps({p.stem: sass_report(read_listing(p), p.stem,
                                              out_dir)
                          for p in args.listing}))
        return
    if args.prev is None:
        ap.error("PREV_DIR is needed")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the comparison needs the card")
    dev = torch.device("cuda", 0)
    card = card_line()
    log("[ab] card:", card)
    prev = PrevMarch(args.prev)
    t0 = time.perf_counter()
    prev.start()
    build.build_all(("march",))
    march_kernel.load("march")
    prev.wait()
    log(f"[ab] built both trees' march.cu in {time.perf_counter() - t0:.2f} "
        f"s; this tree's ptxas: {ptxas_summary(build.ptxas_report('march'))}")
    regs = {"new": ptxas_instances(build.ptxas_report("march")),
            "prev": ptxas_instances(Path(f"{prev.lib_path}.log").read_text())}
    log(f"[ab] (registers, spill bytes) of the instances: {regs}")
    sass = {"new": sass_report(sass_functions(build.library_path("march")),
                               "new", out_dir),
            "prev": sass_report(sass_functions(prev.lib_path), "prev",
                                out_dir)}
    results = {}
    sets = inputs(dev)
    for label, (scene, calls) in sets.items():
        results[label] = ab(label, scene, calls, prev)
    swept = None
    if args.sweep:
        swept = sweep({k: v for k, v in sets.items() if "frame" in k},
                      out_dir, args.also)
    print(json.dumps({"card": card, "readings": READINGS, "ab": results,
                      "registers_spills": regs,
                      "sass_per_object_trip": sass, "sweep": swept}),
          flush=True)


if __name__ == "__main__":
    main()
