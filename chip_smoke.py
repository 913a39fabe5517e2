#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU (or four, --multi).

Phases, in one process (a second process could not open the card while
this one holds it):

  device     fail unless JAX runs on a GPU; print the card and its power
             limit
  kernels    the per-ray walk kernel (traversal/walk.py, Pallas through
             Triton) compiled at real width on hall-260K, compared with
             its plain reference api.traverse on the same card and timed
             against the XLA engine (tiled.py)
  traversal  hall-260K primary / ao / bounces on the production engine
             (traversal.engine.select_engine) against the oracle
  render     mathall (260K triangles, full MTL) at the reference bench
             config 1920x1088 spp 4 max path length 20 through
             `tools.benchmark --mode renderer`, checked against a
             1920x8 strip of the same iterations rendered on the CPU;
             cornell at the reference ctest camera through `tools.render`;
             every golden config of tests/golden held to its MSE gate
  multi      --multi only, on 4 cards: render_iteration_persistent_sharded
             of mathall on meshes (sp=1, px=4) and (sp=2, px=2), and
             traverse_sharded of hall bounces, each against one card

Tolerances, with their reasons:
  traversal  prim_id mismatch share <= 1e-4 and relative t error <= 1e-5
             where both agree: the engines and the oracle run the same
             arithmetic in the same order, so only FMA contraction can
             separate them, and only at near-ties
  strip      share of pixels off by more than 1/255 <= 5% and strip MSE
             <= 4 (u8^2), at 3 iterations (12 samples per pixel): the GPU
             and the CPU differ in FMA contraction and in sqrt/rcp/sin,
             which flips a path's Russian-roulette or BSDF branch, and at
             12 samples one flipped path moves its pixel visibly. Measured
             on an H100: 2.6% of pixels, MSE 1.32; a shading or traversal
             bug moves most pixels
  multi      px only: equal to one card up to the per-pixel order of
             sample splats (|diff| <= 1e-5 relative); sp=2: the psum adds
             two partial films, a different summation order (same bound)

Exits non-zero, printing no result, on any failed phase or when JAX
finds no GPU. The last line of stdout is one JSON object.

Usage: python chip_smoke.py [--multi]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = dict(width=1920, height=1088, spp=4, mpl=20)
HALL_TRIS = 260_000
STRIP_ROWS = 8
STRIP_SHARE = 0.05
STRIP_MSE = 4.0
TRAV_MISMATCH = 1e-4
TRAV_REL_T = 1e-5
MULTI_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def phase_device(n_expected):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {devs[0].platform}")
    if len(devs) < n_expected:
        raise SystemExit(f"need {n_expected} GPUs, found {len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: {devs[0].device_kind} x{len(devs)}")
    log(f"nvidia-smi: {smi}")
    return devs


def hall_setup():
    """hall-260K build + 1024x1024 primary / ao / bounces ray sets."""
    import jax
    import jax.numpy as jnp
    from rodent_tpu.accel import build_bvh
    from rodent_tpu.traversal.api import bvh_to_device, make_rays, traverse
    from rodent_tpu.utils.testscenes import (hall_primary_rays, make_hall,
                                             secondary_rays_from_trace)
    verts, idx = make_hall(HALL_TRIS)
    dev = bvh_to_device(build_bvh(verts, idx, arity=8, packet=8,
                                  leaf_threshold=12))
    org, dirs = hall_primary_rays(1024, 1024)
    n = len(org)
    prim = make_rays(jnp.asarray(org), jnp.asarray(dirs),
                     jnp.zeros(n, jnp.float32),
                     jnp.full(n, 3.402823466e38, jnp.float32))
    oracle = jax.jit(lambda d, r, ah: traverse(d, r, any_hit=ah),
                     static_argnums=2)
    ref = oracle(dev, prim, False)
    dists = {"primary": (prim, False)}
    for kind, ah in (("ao", True), ("bounces", False)):
        o2, d2, tmin2, tmax2 = secondary_rays_from_trace(
            kind, org, dirs, np.asarray(ref["t"]),
            np.asarray(ref["prim_id"]), verts, idx.reshape(-1, 4))
        dists[kind] = (make_rays(jnp.asarray(o2), jnp.asarray(d2),
                                 jnp.asarray(tmin2), jnp.asarray(tmax2)),
                       ah)
    return dev, dists, oracle


def compare_hits(got, want, any_hit):
    """(mismatch share, max relative t error where the hits agree)."""
    gp, wp = np.asarray(got["prim_id"]), np.asarray(want["prim_id"])
    if any_hit:
        return float(np.mean((gp >= 0) != (wp >= 0))), 0.0
    same = (gp == wp) & (wp >= 0)
    gt, wt = np.asarray(got["t"])[same], np.asarray(want["t"])[same]
    rel = np.abs(gt - wt) / np.maximum(np.abs(wt), 1e-30)
    return float(np.mean(gp != wp)), float(rel.max(initial=0.0))


def timed(fn, args, reps=5):
    """Median seconds of reps calls after one warm-up call."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out


def phase_kernels(hall):
    import jax
    from rodent_tpu.traversal.engine import traverse
    dev, dists, oracle = hall
    walk = jax.jit(lambda d, r, ah: traverse(d, r, "walk", any_hit=ah),
                   static_argnums=2)
    xla = jax.jit(lambda d, r, ah: traverse(d, r, "tiled", any_hit=ah,
                                            compact=5), static_argnums=2)
    for kind, (rays, ah) in dists.items():
        n = rays["tmin"].shape[0]
        t_walk, got = timed(walk, (dev, rays, ah))
        t_xla, _ = timed(xla, (dev, rays, ah))
        mis, rel = compare_hits(got, oracle(dev, rays, ah), ah)
        log(f"kernels: walk hall {kind}: {t_walk * 1e3:.3f} ms "
            f"({n / t_walk / 1e6:.1f} Mrays/s) vs XLA tiled-c5 "
            f"{t_xla * 1e3:.3f} ms ({n / t_xla / 1e6:.1f} Mrays/s); "
            f"vs api.traverse: mismatch {mis:.2e}, max rel t {rel:.2e}")
        assert mis <= TRAV_MISMATCH and rel <= TRAV_REL_T, kind
    rays, ah = dists["bounces"]
    mem = walk.lower(dev, rays, ah).compile().memory_analysis()
    log(f"kernels: walk memory_analysis: {mem}")


def phase_traversal(hall):
    import jax
    from rodent_tpu.traversal.engine import select_engine, traverse
    dev, dists, oracle = hall
    engine = select_engine(dev)
    fn = jax.jit(lambda d, r, ah: traverse(d, r, engine, any_hit=ah),
                 static_argnums=2)
    for kind, (rays, ah) in dists.items():
        got = fn(dev, rays, ah)
        mis, rel = compare_hits(got, oracle(dev, rays, ah), ah)
        hits = float(np.mean(np.asarray(got["prim_id"]) >= 0))
        log(f"traversal: hall {kind} on {engine}: hit fraction "
            f"{hits:.4f}, mismatch {mis:.2e}, max rel t {rel:.2e}")
        assert mis <= TRAV_MISMATCH and rel <= TRAV_REL_T, kind


def mathall_scene(mpl):
    from rodent_tpu.render.compiler import compile_mesh
    from rodent_tpu.utils import testscenes
    verts, idx = testscenes.make_hall(HALL_TRIS, rich_mats=True)
    mats, texs = testscenes.mat_hall_materials()
    return compile_mesh(verts, idx, max_path_len=mpl, emitter="inside",
                        materials=mats, tex_images=texs)


def mathall_camera(w, h):
    from rodent_tpu.render.camera import Camera
    from rodent_tpu.tools.benchmark import _RENDER_CAMS
    eye, dirv, fov, _ = _RENDER_CAMS["mathall"]
    return Camera.make(eye, dirv, (0, 1, 0), fov, w, h)


def phase_render(out_dir, iters=2):
    import jax
    from rodent_tpu.render import film as film_mod
    from rodent_tpu.render.compiler import select_render_policy
    from rodent_tpu.render.integrator import render_iteration_persistent
    from rodent_tpu.tools import benchmark, render
    from rodent_tpu.utils.testscenes import CORNELL_OBJ
    W, H, spp, mpl = (BENCH[k] for k in ("width", "height", "spp", "mpl"))

    # mathall through the benchmark tool: iterations 0..iters
    benchmark.main(["--mode", "renderer", "--scenes", "mathall",
                    "--sizes", f"mathall={HALL_TRIS}", "--width", str(W),
                    "--height", str(H), "--spp", str(spp), "--mpl",
                    str(mpl), "--iters", str(iters), "--film-out",
                    out_dir])
    film = np.load(os.path.join(out_dir, "mathall.npy"))
    assert film.shape == (W * H, 3) and np.isfinite(film).all()

    # the same iterations of a 1920x8 strip on the CPU
    cpu = jax.devices("cpu")[0]
    scene = mathall_scene(mpl)
    with jax.default_device(cpu):
        dev_cpu = jax.tree.map(
            lambda x: jax.device_put(x, cpu) if isinstance(x, jax.Array)
            else x, scene.device)
        policy = select_render_policy(dev_cpu, platform="cpu")
        lo, n = (H // 2) * W, STRIP_ROWS * W
        strip = jax.device_put(np.zeros((n, 3), np.float32), cpu)
        cam = mathall_camera(W, H)
        for it in range(iters + 1):
            strip = render_iteration_persistent(
                dev_cpu, cam, strip, W, H, spp, it, pixel_lo=lo,
                n_pixels=n, **policy)
        strip = np.asarray(strip)
    a = film_mod.tonemap(film[lo:lo + n], W, STRIP_ROWS, iters + 1)
    b = film_mod.tonemap(strip, W, STRIP_ROWS, iters + 1)
    diff = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    share = float(np.mean(diff.max(-1) > 1))
    mse = film_mod.mse_u8(a, b)
    log(f"render: mathall strip GPU vs CPU: {share:.4%} of pixels off by "
        f"> 1/255, MSE {mse:.4f} (gates {STRIP_SHARE:.0%}, {STRIP_MSE})")
    assert share <= STRIP_SHARE and mse <= STRIP_MSE

    # cornell at the reference ctest camera through the render tool
    png_out = os.path.join(out_dir, "cornell.png")
    assert render.main([CORNELL_OBJ, "--eye", "0", "1", "2.7", "--dir",
                        "0", "0", "-1", "--width", "1080", "--height",
                        "720", "--bench", "3", "-o", png_out]) == 0
    from rodent_tpu.io import png
    img = png.read_png(png_out)[..., :3]
    log(f"render: cornell 1080x720 mean {img.mean():.2f}")
    assert img.mean() > 10 and img.std() > 10

    # every golden config, held to the CPU test's gate
    from experiments.make_goldens import build_scene, render as render_g
    gdir = os.path.join(ROOT, "tests", "golden")
    meta = json.load(open(os.path.join(gdir, "golden_meta.json")))
    for name, m in meta.items():
        golden = png.read_png(os.path.join(gdir, f"{name}.png"))[..., :3]
        img = np.asarray(render_g(build_scene(name, m["tris"]), name,
                                  m["test_iters"]))
        mse = film_mod.mse_u8(golden, img)
        gate = 3.0 * m["calib_mse_u8"] + 1.0
        log(f"render: golden {name}: MSE {mse:.2f} (gate {gate:.2f}), "
            f"mean {img.mean():.2f} (golden {m['mean_u8']})")
        assert mse <= gate
        assert abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"]


def phase_multi(devs, hall, W=BENCH["width"], H=BENCH["height"]):
    import jax
    from rodent_tpu.parallel import (make_mesh,
                                     render_iteration_persistent_sharded,
                                     traverse_sharded)
    from rodent_tpu.render import film as film_mod
    from rodent_tpu.render.compiler import select_render_policy
    from rodent_tpu.render.integrator import render_iteration_persistent
    from rodent_tpu.traversal.engine import select_engine
    from rodent_tpu.traversal.engine import traverse
    spp = BENCH["spp"]
    scene = mathall_scene(BENCH["mpl"])
    policy = select_render_policy(scene.device)
    cam = mathall_camera(W, H)
    t0 = time.perf_counter()
    single = np.asarray(render_iteration_persistent(
        scene.device, cam, film_mod.new_film(W, H), W, H, spp, 0,
        **policy))
    log(f"multi: one card {time.perf_counter() - t0:.1f} s "
        f"(compile included)")
    scale = float(np.abs(single).max())
    for n_sp, n_px in ((1, 4), (2, 2)):
        mesh = make_mesh(n_px=n_px, n_sp=n_sp, devices=devs[:4])
        for _ in range(2):
            t0 = time.perf_counter()
            out = render_iteration_persistent_sharded(
                scene.device, cam, film_mod.new_film(W, H), W, H, spp, 0,
                mesh, **policy)
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
        placed = len(out.sharding.device_set)
        got = np.asarray(out)
        diff = float(np.abs(got - single).max())
        log(f"multi: mesh sp={n_sp} px={n_px} on {placed} devices: "
            f"{dt:.3f} s warm, max |diff| {diff:.3e} "
            f"(film max {scale:.3e}), bit-identical "
            f"{bool(np.array_equal(got, single))}")
        assert placed == 4 and diff <= MULTI_RTOL * scale
    dev, dists, _ = hall
    rays, ah = dists["bounces"]
    engine = select_engine(dev)
    single_h = jax.jit(lambda d, r: traverse(d, r, engine))(dev, rays)
    hit = traverse_sharded(dev, rays, mesh=make_mesh(devices=devs[:4]),
                           engine=engine)
    placed = len(hit["t"].sharding.device_set)
    same = bool(np.array_equal(np.asarray(hit["prim_id"]),
                               np.asarray(single_h["prim_id"]))
                and np.array_equal(np.asarray(hit["t"]),
                                   np.asarray(single_h["t"])))
    log(f"multi: traverse_sharded hall bounces on {placed} devices, "
        f"identical to one card: {same}")
    assert placed == 4 and same


def main(argv=None):
    ap = argparse.ArgumentParser(prog="chip_smoke")
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1
    devs = phase_device(n_cards)
    from rodent_tpu.utils.compile import enable_compile_cache
    enable_compile_cache()
    t0 = time.perf_counter()
    hall = hall_setup()
    log(f"setup: hall-260K and its rays in {time.perf_counter() - t0:.1f} s")
    if args.multi:
        phase_multi(devs, hall)
    else:
        phase_kernels(hall)
        phase_traversal(hall)
        with tempfile.TemporaryDirectory() as out_dir:
            phase_render(out_dir)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
