#!/usr/bin/env python
"""Headline benchmark + full metric set on one GPU.

Headline: primary-ray traversal throughput (Mrays/s), the reference's
bench_traversal metric ("N Mrays/sec", tools/bench_traversal). Detail
carries the reference's full distribution triple (primary / ao / bounces,
benchmarks/benchmark.py) with each distribution's agreement with the
api.traverse oracle, a 4.3M-triangle powerplant primary row, and the
cornell renderer: throughput (Msamples/s, driver.cpp:341-348) at the
ctest config 1080x720 spp 4, and the MSE against the in-repo golden film
(tests/golden/cornell.png) at the golden's own config.

Workload: a 260K-triangle sponza-class procedural hall (the sponza mesh
is not redistributable; see rodent_tpu/utils/testscenes.py), 1024x1024
rays, traced by the production engine (traversal.engine.select_engine).
Fails unless JAX runs on a GPU. Prints ONE JSON line.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _median_rate(fn, args, n, iters=5, blocks=5):
    """Median, min and max Mrays/s of `blocks` timed blocks of `iters`
    calls each (bench_traversal.cpp:336-391 reports avg/median/min over
    iterations), plus the last result."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        rates.append(n * iters / (time.perf_counter() - t0) / 1e6)
    rates.sort()
    return rates[len(rates) // 2], rates[0], rates[-1], out


def gpu_identity():
    """(name, power limit) of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in out.split(","))
    return name, power


def main():
    import jax
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev0.platform}",
              file=sys.stderr)
        return 1
    from rodent_tpu.utils.compile import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from rodent_tpu.accel import build_bvh
    from rodent_tpu.traversal.api import bvh_to_device, make_rays, traverse
    from rodent_tpu.traversal.engine import select_engine
    from rodent_tpu.traversal.engine import traverse as engine_traverse
    from rodent_tpu.traversal.sorting import sort_rays
    from rodent_tpu.utils.testscenes import (hall_primary_rays, make_hall,
                                             secondary_rays_from_trace)

    name, power = gpu_identity()
    detail = {"platform": dev0.platform, "device_kind": dev0.device_kind,
              "device_count": len(jax.devices()), "gpu_name": name,
              "power_limit": power}

    # ---- traversal triple on the hall scene ----
    verts, idx = make_hall(260_000)
    bvh = build_bvh(verts, idx, arity=8, packet=8, leaf_threshold=12)
    dev = bvh_to_device(bvh)
    engine = select_engine(dev)
    detail["engine"] = engine
    detail["num_nodes"] = int(bvh.num_nodes)
    detail["num_packets"] = int(bvh.num_packets)
    fn = jax.jit(lambda d, r, ah: engine_traverse(d, r, engine, any_hit=ah),
                 static_argnums=2)
    oracle = jax.jit(lambda d, r, ah: traverse(d, r, any_hit=ah),
                     static_argnums=2)

    org, dirs = hall_primary_rays(1024, 1024)
    n = len(org)
    prim = make_rays(jnp.asarray(org), jnp.asarray(dirs),
                     jnp.zeros(n, jnp.float32),
                     jnp.full(n, 3.402823466e38, jnp.float32))
    ref = oracle(dev, prim, False)
    dists = {"primary": (prim, False)}
    t = np.asarray(ref["t"])
    pid = np.asarray(ref["prim_id"])
    for kind, any_hit in (("ao", True), ("bounces", False)):
        o2, d2, tmin2, tmax2 = secondary_rays_from_trace(
            kind, org, dirs, t, pid, verts, idx.reshape(-1, 4))
        dists[kind] = (make_rays(jnp.asarray(o2), jnp.asarray(d2),
                                 jnp.asarray(tmin2), jnp.asarray(tmax2)),
                       any_hit)
    for kind, (rays, any_hit) in dists.items():
        rays, _ = sort_rays(rays, verts.min(0), verts.max(0))
        m, lo, hi, hit = _median_rate(fn, (dev, rays, any_hit), n)
        want = np.asarray(oracle(dev, rays, any_hit)["prim_id"])
        got = np.asarray(hit["prim_id"])
        agree = (np.mean((got >= 0) == (want >= 0)) if any_hit
                 else np.mean(got == want))
        detail[f"{kind}_mrays"] = m
        detail[f"{kind}_band"] = [lo, hi]
        detail[f"{kind}_hit_fraction"] = float(np.mean(got >= 0))
        detail[f"{kind}_oracle_agreement"] = float(agree)

    # ---- powerplant-class big scene ----
    from rodent_tpu.utils.testscenes import (make_powerplant,
                                             powerplant_primary_rays)
    bverts, bidx = make_powerplant(5_000_000)
    bdev = bvh_to_device(build_bvh(bverts, bidx, arity=8, packet=8,
                                   leaf_threshold=12, quality=0))
    borg, bdirs = powerplant_primary_rays(1024, 1024)
    bn = len(borg)
    brays = make_rays(jnp.asarray(borg), jnp.asarray(bdirs),
                      jnp.zeros(bn, jnp.float32),
                      jnp.full(bn, 3.402823466e38, jnp.float32))
    brays, _ = sort_rays(brays, bverts.min(0), bverts.max(0))
    bengine = select_engine(bdev)
    bfn = jax.jit(lambda d, r: engine_traverse(d, r, bengine))
    m, lo, hi, _ = _median_rate(bfn, (bdev, brays), bn, iters=3)
    detail["bigscene_tris"] = len(bidx) // 4
    detail["bigscene_mrays"] = m
    detail["bigscene_band"] = [lo, hi]
    del bdev, brays

    # ---- cornell renderer: throughput + golden gate ----
    from rodent_tpu.io import png
    from rodent_tpu.render import film as film_mod
    from rodent_tpu.render.camera import Camera
    from rodent_tpu.render.compiler import compile_obj, select_render_policy
    from rodent_tpu.render.integrator import render_iteration_persistent
    from rodent_tpu.tools.quality_gate import default_threshold
    from rodent_tpu.utils.testscenes import CORNELL_OBJ

    scene = compile_obj(CORNELL_OBJ, max_path_len=8)
    policy = select_render_policy(scene.device)
    detail["cornell_policy"] = policy

    def render(w, h, spp, iters):
        cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, w, h)
        film = render_iteration_persistent(scene.device, cam,
                                           film_mod.new_film(w, h), w, h,
                                           spp, 0, **policy)
        jax.block_until_ready(film)
        t0 = time.perf_counter()
        for it in range(1, iters):
            film = render_iteration_persistent(scene.device, cam, film, w,
                                               h, spp, it, **policy)
        jax.block_until_ready(film)
        rate = w * h * spp * (iters - 1) / (time.perf_counter() - t0) / 1e6
        return film_mod.tonemap(film, w, h, iters), rate

    _, detail["cornell_msamples"] = render(1080, 720, 4, 20)
    golden = png.read_png(os.path.join(ROOT, "tests", "golden",
                                       "cornell.png"))[..., :3]
    gh, gw = golden.shape[:2]
    iters = 50
    img, _ = render(gw, gh, 4, iters)
    detail["cornell_mse_u8"] = film_mod.mse_u8(golden, img)
    detail["cornell_mse_gate"] = default_threshold(iters)
    detail["cornell_iters"] = iters
    if detail["cornell_mse_u8"] > detail["cornell_mse_gate"]:
        print("cornell MSE above its gate", file=sys.stderr)
        return 1

    print(json.dumps({
        "metric": "hall260k_primary_traversal",
        "value": detail["primary_mrays"],
        "unit": "Mrays/s",
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
