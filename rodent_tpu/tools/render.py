"""render: the interactive driver analog (headless).

CLI mirrors src/driver/driver.cpp:169-232 (--eye/--dir/--up/--fov/
--width/--height/--bench/-o) plus scene/spp/max-path-len which the
reference bakes in at converter time. Progressive accumulation, bench mode
reporting "# min/med/max (Msamples/s)" exactly like driver.cpp:341-348.

Usage:
  python -m rodent_tpu.tools.render scene.obj --bench 50 \
      --eye 0 1 2.7 --dir 0 0 -1 -o out.png
"""
from __future__ import annotations

import argparse
import sys
import time



def main(argv=None):
    p = argparse.ArgumentParser(prog="render")
    p.add_argument("scene")
    p.add_argument("--width", type=int, default=1080)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--dir", type=float, nargs=3, default=(0.0, 0.0, 1.0))
    p.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--bench", type=int, default=1,
                   help="number of progressive iterations")
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--max-path-len", type=int, default=64)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="render over all devices (image-plane sharding)")
    p.add_argument("--debug", action="store_true",
                   help="eye-light debug renderer (make_debug_renderer, "
                        "renderer.impala:42-60): no NEE/bounces, spp 1")
    p.add_argument("--progressive", action="store_true",
                   help="full-width progressive wavefront instead of the "
                        "persistent 32K regeneration pool (films are "
                        "bit-identical; persistent is ~4x faster)")
    p.add_argument("--profile", action="store_true",
                   help="per-stage wall-time report at exit (the "
                        "reference's cpu_profile percentages, "
                        "mapping_cpu.impala:453-472; one iteration is "
                        "a single fused program, so the stages are "
                        "compile/render/tonemap/io)")
    p.add_argument("--sort", choices=("auto", "on", "off", "pool"),
                   default="auto",
                   help="re-sort the wavefront every bounce before "
                        "traversal (the reference's per-bounce "
                        "sort_rays, mapping_cpu.impala:409): +32%% on "
                        "hall-class scenes, films bit-identical; auto "
                        "enables it for non-trivial scenes (>16K tris)")
    p.add_argument("--traversal", choices=("auto", "tiled", "dense",
                                           "walk"),
                   default="auto",
                   help="traversal engine (traversal.engine): auto takes "
                        "the measured render policy for this backend "
                        "(compiler.select_render_policy); tiled, dense "
                        "or walk force one engine")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_obj, select_render_policy
    from ..render.integrator import render_iteration
    from ..io import png

    scene = compile_obj(args.scene, max_path_len=args.max_path_len)
    # the persistent paths take the full measured policy (engine +
    # compaction + pool + retirement) under --traversal auto; explicit
    # engines and the progressive/debug paths take the engine alone
    policy = None
    if args.traversal == "auto":
        policy = dict(select_render_policy(scene.device))
        engine = policy["engine"]
    else:
        engine = args.traversal
    num_tris = scene.device["tri_geo"].shape[0]
    sort = ("pool" if args.sort == "pool" else
            (args.sort == "on"
             or (args.sort == "auto" and num_tris > 16384)))
    if policy is not None and args.sort != "auto":
        policy["sort"] = sort  # explicit --sort overrides the policy
    cam = Camera.make(args.eye, args.dir, args.up, args.fov,
                      args.width, args.height)
    film = film_mod.new_film(args.width, args.height)

    if args.debug:
        from ..render.integrator import render_debug
        args.spp = 1
        step = lambda f, i: render_debug(
            scene.device, cam, f, args.width, args.height, i,
            engine=engine)
    elif args.sharded:
        from ..parallel import (make_mesh, render_iteration_sharded,
                                render_iteration_persistent_sharded)
        mesh = make_mesh()
        if args.progressive:
            step = lambda f, i: render_iteration_sharded(
                scene.device, cam, f, args.width, args.height, args.spp, i,
                mesh, engine=engine, sort=sort)
        else:
            kw = (policy if policy is not None
                  else dict(engine=engine, sort=sort))
            step = lambda f, i: render_iteration_persistent_sharded(
                scene.device, cam, f, args.width, args.height, args.spp, i,
                mesh, **kw)
    elif args.progressive:
        step = lambda f, i: render_iteration(
            scene.device, cam, f, args.width, args.height, args.spp, i,
            engine=engine, sort=sort)
    else:
        # persistent regeneration pool: same film bit-for-bit (RNG seeds
        # depend only on sample/iter/pixel), ~4x the progressive
        # throughput (mapping_gpu.impala:371-474's megakernel trick)
        from ..render.integrator import render_iteration_persistent
        kw = (policy if policy is not None
              else dict(engine=engine, sort=sort))
        step = lambda f, i: render_iteration_persistent(
            scene.device, cam, f, args.width, args.height, args.spp, i,
            **kw)

    from ..utils.profiling import StageProfiler
    prof = StageProfiler(enabled=args.profile, unit="Msamples")

    samples_per_iter = args.width * args.height * args.spp
    times = []
    for it in range(args.bench):
        t0 = time.perf_counter()
        film = step(film, it)
        jax.block_until_ready(film)
        dt = time.perf_counter() - t0
        times.append(dt)
        prof.add("compile+render" if it == 0 else "render", dt)
        prof.add_rays(samples_per_iter)

    # skip the compile iteration in stats when we have more than one
    stats = times[1:] if len(times) > 1 else times
    msamples = sorted(samples_per_iter / t * 1e-6 for t in stats)
    print("# {:.2f}/{:.2f}/{:.2f} (min/med/max Msamples/s)".format(
        msamples[0], msamples[len(msamples) // 2], msamples[-1]))

    if args.output:
        t0 = time.perf_counter()
        img = film_mod.tonemap(film, args.width, args.height, args.bench)
        prof.add("tonemap", time.perf_counter() - t0)
        t0 = time.perf_counter()
        png.write_png(args.output, img)
        prof.add("io", time.perf_counter() - t0)
        print(f"wrote {args.output}")
    if args.profile:
        print(prof.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
