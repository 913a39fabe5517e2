"""bench_ref: the independent competitor engine benchmark.

Role twin of tools/bench_embree/bench_embree.cpp and tools/bench_aila
(the reference benches Embree and Aila's CUDA kernels on the same
.obj + .rays workloads to anchor its own numbers against engines it did
not write). Embree and CUDA do not exist here; the analog is
native/ref_bvh.cpp — a self-contained single-ray BVH2 with its own
binned-SAH builder and scalar stack traversal, sharing no code with the
JAX engines or the production BVH builder. Every throughput row of the
benchmarks can therefore be anchored against a measurement the code
under test did not produce, and every hit result cross-checked against
an implementation that was never derived from it.

Deliberately jax-free: numpy + ctypes only, so the anchor cannot inherit
a bug (or a flattering timing path) from the stack it is anchoring.
Single-threaded, timed inside the C engine.

CLI mirrors bench_embree (obj/ray/tmin/tmax/bench/warmup/any/output);
--scene/--dist generate the procedural fixtures + distributions that
bench.py and tools/benchmark use, for like-for-like rows.

Usage:
  python -m rodent_tpu.tools.bench_ref -obj scene.obj -ray cam.rays
      [--tmin T] [--tmax T] [-any] [--bench N] [--warmup N] [-o out.fbuf]
  python -m rodent_tpu.tools.bench_ref --scene hall --dist ao --bench 5
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _load_scene(args):
    if args.obj:
        from ..io import obj as obj_io
        mesh, _, _ = obj_io.load_scene_mesh(args.obj)
        return np.asarray(mesh.vertices, np.float32), \
            np.asarray(mesh.indices, np.int32).reshape(-1, 4)
    from ..utils import testscenes
    maker = {"hall": testscenes.make_hall,
             "crown": testscenes.make_crown,
             "powerplant": testscenes.make_powerplant}[args.scene]
    kw = {}
    if args.tris:
        kw["target_tris"] = args.tris
    verts, idx = maker(**kw)
    return np.asarray(verts, np.float32), \
        np.asarray(idx, np.int32).reshape(-1, 4)


def _make_rays(args, verts, idx4, tracer):
    if args.ray:
        from ..io import formats
        r = formats.read_rays(args.ray, tmin=args.tmin, tmax=args.tmax)
        return r["org"], r["dir"], r["tmin"], r["tmax"]
    from ..utils import testscenes
    prim_fn = {"hall": testscenes.hall_primary_rays,
               "crown": testscenes.crown_primary_rays,
               "powerplant": testscenes.powerplant_primary_rays}[args.scene]
    org, dirs = prim_fn(args.width, args.height)
    org = np.asarray(org, np.float32)
    dirs = np.asarray(dirs, np.float32)
    n = len(org)
    if args.dist == "primary":
        return (org, dirs, np.zeros(n, np.float32),
                np.full(n, args.tmax, np.float32))
    # secondary distributions need primary hit points; generate them with
    # THIS engine so the workload never depends on the code under test
    t, pid, _ = tracer.traverse(org, dirs, 0.0, 3.402823466e38)
    o2, d2, tmin2, tmax2 = testscenes.secondary_rays_from_trace(
        args.dist, org, dirs, np.asarray(t), np.asarray(pid), verts, idx4)
    return (np.asarray(o2, np.float32), np.asarray(d2, np.float32),
            tmin2, np.asarray(tmax2, np.float32))


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_ref")
    p.add_argument("-obj", "--obj", default=None,
                   help="OBJ file (exclusive with --scene)")
    p.add_argument("--scene", choices=("hall", "crown", "powerplant"),
                   default=None, help="procedural fixture (testscenes)")
    p.add_argument("--tris", type=int, default=None,
                   help="procedural scene size (maker default otherwise)")
    p.add_argument("-ray", "--ray", default=None, help=".rays file")
    p.add_argument("--dist", choices=("primary", "ao", "bounces"),
                   default="primary",
                   help="generated distribution when no --ray is given")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--tmin", type=float, default=0.0)
    p.add_argument("--tmax", type=float, default=1e9)
    p.add_argument("--bench", type=int, default=1,
                   help="timed iterations")
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("-any", "--any", action="store_true",
                   help="exit at the first intersection")
    p.add_argument("--closest", action="store_true",
                   help="force closest-hit even for --dist ao")
    p.add_argument("-o", "--output", default=None,
                   help="dump hit t per ray as .fbuf")
    args = p.parse_args(argv)
    if bool(args.obj) == bool(args.scene):
        p.error("exactly one of -obj / --scene is required")
    if args.obj and not args.ray:
        p.error("-obj mode needs a -ray file (bench_embree takes both); "
                "--scene generates its own distributions")
    # the rows this tool anchors always run ao as any-hit occlusion
    # (bench.py, tools/benchmark.py); imply it so the default anchor is
    # like-for-like. --closest restores a closest-hit ao measurement.
    if args.dist == "ao" and not args.closest:
        args.any = True

    from ..native import RefTracer, available
    if not available():
        print("native library unavailable (no compiler?)", file=sys.stderr)
        return 1

    verts, idx4 = _load_scene(args)
    tracer = RefTracer(verts, idx4)
    org, dirs, tmin, tmax = _make_rays(args, verts, idx4, tracer)
    n = len(org)

    for _ in range(args.warmup):
        tracer.traverse(org, dirs, tmin, tmax, any_hit=args.any)
    timings = []
    t = prim = None
    for _ in range(max(args.bench, 1)):
        t, prim, secs = tracer.traverse(org, dirs, tmin, tmax,
                                        any_hit=args.any)
        timings.append(secs * 1e3)
    timings.sort()
    total = sum(timings)
    iters = len(timings)
    intr = int((prim >= 0).sum())
    # output shape of bench_embree.cpp:407-413
    print(f"{total}ms for {iters} iteration(s)")
    print(f"{n * iters / (1000.0 * total)} Mrays/sec")
    print(f"# Average: {total / iters} ms")
    print(f"# Median: {timings[iters // 2]} ms")
    print(f"# Min: {timings[0]} ms")
    print(f"{intr} intersection(s)")

    if args.output:
        from ..io import formats
        out = ((prim >= 0).astype(np.float32) if args.any
               else np.asarray(t, np.float32))
        formats.write_fbuf(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
