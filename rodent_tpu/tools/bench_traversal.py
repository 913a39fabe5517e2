"""bench_traversal: the Mrays/s benchmark + correctness harness.

CLI mirrors tools/bench_traversal/bench_traversal.cpp: loads a .bvh and a
.rays file, runs warmup + timed iterations of closest-hit (intersect) or
any-hit (occluded, -any) traversal, prints the intersection count and
"N Mrays/sec" (the exact output shape parsed by benchmarks/benchmark.py),
and optionally dumps hit distances as .fbuf.

Usage:
  python -m rodent_tpu.tools.bench_traversal -bvh scene.bvh -ray cam.rays
      [--tmin T] [--tmax T] [-any] [--bench N] [--warmup N] [-o out.fbuf]
      [--bvh-width 8] [--engine auto] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_traversal")
    p.add_argument("-bvh", "--bvh", required=True)
    p.add_argument("-ray", "--ray", required=True)
    p.add_argument("--tmin", type=float, default=0.0)
    p.add_argument("--tmax", type=float, default=3.402823466e38)
    p.add_argument("-any", "--any", action="store_true",
                   help="any-hit (occlusion) instead of closest-hit")
    p.add_argument("--bench", type=int, default=1,
                   help="timed iterations")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("-o", "--output", default=None,
                   help="dump hit t per ray as .fbuf")
    p.add_argument("--bvh-width", type=int, default=None, choices=(2, 4, 8),
                   help="which BVH block to load (default: first present)")
    p.add_argument("--sort", action="store_true",
                   help="octant+Morton ray reordering before traversal "
                        "(helps incoherent distributions)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--engine", choices=("auto", "tiled", "tiled-c",
                                        "dense", "walk"),
                   default="auto",
                   help="traversal engine (traversal.engine): auto picks "
                        "the production engine for this backend; tiled "
                        "is the XLA lockstep loop (tiled-c adds staged "
                        "row compaction), dense brute-forces small "
                        "scenes, walk is the per-ray GPU kernel")
    p.add_argument("--sharded", action="store_true",
                   help="scene-replicated, ray-sharded traversal over "
                        "all devices (SURVEY §2.5 multi-device config)")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ..accel.layout import WideBvh
    from ..io import formats
    from ..traversal.api import bvh_to_device, make_rays
    from ..traversal.engine import select_engine, traverse

    btype = {2: formats.BVH2_TRI1, 4: formats.BVH4_TRI4,
             8: formats.BVH8_TRI4}.get(args.bvh_width)
    block = formats.read_bvh(args.bvh, btype)
    bvh = WideBvh.from_block(block)
    dev = bvh_to_device(bvh)
    engine = (select_engine(dev) if args.engine == "auto"
              else args.engine.removesuffix("-c"))
    compact = 5 if args.engine == "tiled-c" else 0
    kw = {"compact": compact} if compact else {}

    r = formats.read_rays(args.ray, tmin=args.tmin, tmax=args.tmax)
    n = len(r["org"])
    rays = make_rays(jnp.asarray(r["org"]), jnp.asarray(r["dir"]),
                     jnp.asarray(r["tmin"]), jnp.asarray(r["tmax"]))

    inv_perm = None
    if args.sort:
        import numpy as _np
        from ..traversal.sorting import sort_rays
        root_lo = _np.asarray([bvh.bounds[0, 0, :].min(),
                               bvh.bounds[0, 2, :].min(),
                               bvh.bounds[0, 4, :].min()])
        root_hi = _np.asarray([bvh.bounds[0, 1, :].max(),
                               bvh.bounds[0, 3, :].max(),
                               bvh.bounds[0, 5, :].max()])
        rays, perm = sort_rays(rays, root_lo, root_hi)
        inv_perm = jnp.argsort(perm)

    if args.sharded:
        from ..parallel.mesh import make_mesh, traverse_sharded
        mesh = make_mesh()
        n_dev = mesh.devices.size
        if n % n_dev:  # pad to a shardable count with dead rays
            pad = n_dev - n % n_dev
            rays = {k: jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:],
                             -1.0 if k == "tmax" else 0.0, v.dtype)])
                for k, v in rays.items()}
        fn = jax.jit(lambda rr: traverse_sharded(
            dev, rr, mesh=mesh, any_hit=args.any, engine=engine, **kw))
    else:
        fn = jax.jit(lambda rr: traverse(dev, rr, engine,
                                         any_hit=args.any, **kw))
    hit = None
    for _ in range(max(args.warmup, 1)):
        hit = fn(rays)
    jax.block_until_ready(hit["t"])

    times = []
    for _ in range(max(args.bench, 1)):
        t0 = time.perf_counter()
        hit = fn(rays)
        jax.block_until_ready(hit["t"])
        times.append(time.perf_counter() - t0)

    hit = {k: v[:n] for k, v in hit.items()}
    if inv_perm is not None:
        hit = {k: v[inv_perm] for k, v in hit.items()}
    prim = np.asarray(hit["prim_id"])
    intr = int((prim >= 0).sum())
    times_ms = np.asarray(times) * 1e3
    avg = float(times_ms.mean())
    med = float(np.median(times_ms))
    mn = float(times_ms.min())
    print(f"{intr} intersection(s)")
    print(f"# avg/med/min: {avg:.2f}/{med:.2f}/{mn:.2f} ms")
    print(f"{n * 1e-6 / (med * 1e-3):.2f} Mrays/sec")

    if args.output:
        t = np.asarray(hit["t"], np.float32)
        if args.any:
            # occlusion dump: 1 where blocked, 0 otherwise
            t = (prim >= 0).astype(np.float32)
        formats.write_fbuf(args.output, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
