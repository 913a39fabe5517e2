"""benchmark: the multi-config sweep harness (benchmarks/benchmark.py role).

The reference's harness runs bench_traversal over scene x ray-distribution
x kernel-variant and prints one line per config in the format
`scene : distribution : variant : Mrays` (benchmarks/benchmark.py:28-52,
results_par.txt). This tool reproduces that sweep on the procedural scene
fixtures (sponza-class hall, crown-class, powerplant-class — the real
meshes are not redistributable) and the traversal engines of
traversal.engine:

  walk     per-ray stack kernel, Pallas through Triton (GPU only)
  tiled    XLA lockstep loop (tiled-c adds staged row compaction)
  dense    brute force over every Tri packet (tiny scenes only)

--mode renderer runs the full path tracer on the same scenes instead
(compile_mesh supplies materials + an area light) at the reference's
benchmark config 1920x1088 / spp 4 / max-path-len 20
(benchmarks/bench.sh:60-85) and prints Msamples/s rows; --film-out DIR
also saves each scene's film as DIR/<scene>.npy.

Usage:
  python -m rodent_tpu.tools.benchmark [--scenes hall,crown,powerplant]
      [--dists primary,ao,bounces] [--variants walk,tiled-c]
      [--rays 1048576] [--iters 3] [--sizes hall=260000,...]
      [--mode traversal|renderer] [--film-out DIR]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

_SCENES = {
    "hall": ("make_hall", "hall_primary_rays", 260_000),
    # mathall: hall geometry with the full-MTL bench materials (textured
    # kd + phong + mix + glass + mirror columns, mat_hall_materials) —
    # the reference's bench interiors are full-MTL (bench.sh:9-85,
    # converter.cpp:859-927); the plain scenes are palette-diffuse only
    "mathall": ("make_hall", "hall_primary_rays", 260_000),
    "crown": ("make_crown", "crown_primary_rays", 800_000),
    "powerplant": ("make_powerplant", "powerplant_primary_rays",
                   2_000_000),
}


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("--scenes", default="hall,crown,powerplant")
    p.add_argument("--dists", default="primary,ao,bounces")
    p.add_argument("--variants", default="walk,tiled-c")
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--sizes", default="",
                   help="override scene sizes: hall=100000,crown=500000")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--mode", choices=("traversal", "renderer"),
                   default="traversal")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1088)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--mpl", type=int, default=20,
                   help="max path length (reference bench.sh uses 20)")
    p.add_argument("--film-out", default=None,
                   help="renderer mode: save each film as DIR/<scene>.npy")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ..utils.compile import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from ..accel import build_bvh
    from ..traversal.api import bvh_to_device, make_rays
    from ..traversal.engine import traverse
    from ..traversal.sorting import sort_rays
    from ..utils import testscenes
    from ..utils.testscenes import hall_secondary_rays

    sizes = {}
    for tok in args.sizes.split(","):
        if "=" in tok:
            k, v = tok.split("=")
            sizes[k] = int(v)

    if args.mode == "renderer":
        return _renderer_sweep(args, sizes)

    side = int(np.sqrt(args.rays))
    n = side * side
    variants = args.variants.split(",")
    engines = {
        "walk": lambda dev, r, ah: traverse(dev, r, "walk", any_hit=ah),
        "tiled": lambda dev, r, ah: traverse(dev, r, "tiled", any_hit=ah),
        # staged row compaction: pays when the cone sort makes rows die
        # together
        "tiled-c": lambda dev, r, ah: traverse(dev, r, "tiled",
                                               any_hit=ah, compact=5),
        "dense": lambda dev, r, ah: traverse(dev, r, "dense", any_hit=ah),
    }

    for scene in args.scenes.split(","):
        make_name, rays_name, dflt = _SCENES[scene]
        tris = sizes.get(scene, dflt)
        verts, idx = getattr(testscenes, make_name)(tris)
        # quality=0 (binned SAH) keeps the multi-million-triangle
        # builds tractable
        bvh = build_bvh(verts, idx, arity=8, packet=8, leaf_threshold=12,
                        quality=0 if scene == "powerplant" else 1)
        dev = bvh_to_device(bvh)
        lo, hi = verts.min(0), verts.max(0)
        org, dirs = getattr(testscenes, rays_name)(side, side)
        prim = make_rays(jnp.asarray(org), jnp.asarray(dirs),
                         jnp.zeros(n, jnp.float32),
                         jnp.full(n, 3.402823466e38, jnp.float32))

        # hit points for the secondary distributions (ray_gen role)
        hit = jax.jit(engines["tiled-c"], static_argnums=2)(dev, prim,
                                                          False)
        t = np.asarray(hit["t"])
        pid = np.asarray(hit["prim_id"])
        t = np.where(pid >= 0, t, 1.0)
        hp = org + dirs * t[:, None]
        i4 = idx.reshape(-1, 4)
        tri = np.maximum(pid, 0)
        v0, v1, v2 = (verts[i4[tri, 0]], verts[i4[tri, 1]],
                      verts[i4[tri, 2]])
        fn = np.cross(v0 - v1, v2 - v0)
        fn = np.where((fn * dirs).sum(1, keepdims=True) > 0, -fn, fn)

        dists = {}
        if "primary" in args.dists:
            dists["primary"] = (prim, False)
        for kind, ah in (("ao", True), ("bounces", False)):
            if kind not in args.dists:
                continue
            o2, d2, tmax2 = hall_secondary_rays(kind, hp, fn)
            dists[kind] = (make_rays(jnp.asarray(o2), jnp.asarray(d2),
                                     jnp.full(n, 1e-3, jnp.float32),
                                     jnp.asarray(tmax2)), ah)

        for dist, (rays, ah) in dists.items():
            srt, _ = sort_rays(rays, lo, hi)
            for variant in variants:
                # dev rides as a jit ARGUMENT: closure capture would bake
                # the tables into the HLO as constants
                fn_t = jax.jit(lambda d, r, e=engines[variant], a=ah:
                               e(d, r, a))
                out = fn_t(dev, srt)
                jax.block_until_ready(out)
                # avg/median/min like the reference harness
                # (bench_traversal.cpp:336-391)
                times = []
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    out = fn_t(dev, srt)
                    jax.block_until_ready(out)
                    times.append(time.perf_counter() - t0)
                times = np.asarray(times)
                mr = n / times / 1e6
                hits = int(np.asarray(
                    (out["prim_id"] >= 0)).sum())
                print(f"{scene} : {dist} : {variant} : "
                      f"{np.median(mr):.2f} Mrays "
                      f"(avg {mr.mean():.2f}, min {mr.min():.2f}, "
                      f"max {mr.max():.2f}, n={args.iters}; "
                      f"{hits} intersections)", flush=True)


# camera + emitter placement per scene (matches the *_primary_rays
# viewpoints in utils.testscenes)
_RENDER_CAMS = {
    "hall": ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), 60.0, "inside"),
    "mathall": ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), 60.0, "inside"),
    "crown": ((4.2, 1.8, 1.2), (-4.2, -1.4, -1.2), 42.0, "above"),
    "powerplant": ((-30.0, 60.0, -30.0), (130.0, -40.0, 130.0), 55.0,
                   "above"),
}


def _renderer_sweep(args, sizes):
    """Full path-tracer throughput on the benchmark scenes (the
    reference's bench.sh renderer rows)."""
    W, H, spp = args.width, args.height, args.spp
    for scene_name in args.scenes.split(","):
        _render_one(args, sizes, scene_name, W, H, spp)


def _render_one(args, sizes, scene_name, W, H, spp):
    import os

    import jax

    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_mesh, select_render_policy
    from ..render.integrator import render_iteration_persistent
    from ..utils import testscenes

    make_name, _rays, dflt = _SCENES[scene_name]
    tris = sizes.get(scene_name, dflt)
    eye, dirv, fov, emitter = _RENDER_CAMS[scene_name]
    if scene_name == "mathall":
        verts, idx = testscenes.make_hall(tris, rich_mats=True)
        mats, texs = testscenes.mat_hall_materials()
        scene = compile_mesh(verts, idx, max_path_len=args.mpl,
                             emitter=emitter, materials=mats,
                             tex_images=texs)
    else:
        verts, idx = getattr(testscenes, make_name)(tris)
        scene = compile_mesh(verts, idx, max_path_len=args.mpl,
                             emitter=emitter)
    policy = select_render_policy(scene.device)
    cam = Camera.make(eye, dirv, (0, 1, 0), fov, W, H)
    film = film_mod.new_film(W, H)
    film = render_iteration_persistent(scene.device, cam, film, W, H,
                                       spp, 0, **policy)
    jax.block_until_ready(film)
    times = []
    for it in range(1, args.iters + 1):
        t0 = time.perf_counter()
        film = render_iteration_persistent(scene.device, cam, film,
                                           W, H, spp, it, **policy)
        jax.block_until_ready(film)
        times.append(time.perf_counter() - t0)
    ms = np.sort(W * H * spp / np.asarray(times) / 1e6)
    mean_lum = float(np.asarray(film).mean()) / (args.iters + 1)
    eng = policy["engine"] + (f"-c{policy['compact']}"
                              if policy.get("compact") else "")
    if args.film_out:
        os.makedirs(args.film_out, exist_ok=True)
        np.save(os.path.join(args.film_out, f"{scene_name}.npy"),
                np.asarray(film))
    print(f"{scene_name} : render({W}x{H} spp{spp} mpl{args.mpl}, "
          f"traversal={eng}) : "
          f"{ms[len(ms) // 2]:.2f} Msamples/s "
          f"(min {ms[0]:.2f}, max {ms[-1]:.2f}, n={args.iters}; "
          f"mean film {mean_lum:.4f})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
