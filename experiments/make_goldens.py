#!/usr/bin/env python
"""Generate converged golden films for the renderer's golden-image gates.

Renders cornell (the in-repo fixture) and the procedural bench scenes
hall / crown / mathall at a small fixed config, writes
tests/golden/<scene>.png plus golden_meta.json carrying the creation-
time MSE of a SHORT (test-budget) render against the converged film —
tests/test_golden_scenes.py gates at 3x that calibrated noise level.

The goldens are platform-portable: the RNG is bit-exact by construction
(FNV + xorshift32 on u32) and the MSE gate absorbs float scheduling
differences between backends.

Usage: python experiments/make_goldens.py [--iters 30] [--scenes cornell]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

# one fixed config per scene: (tris, W, H, spp, eye, dir, fov, emitter)
CONFIGS = {
    "cornell": (None, 192, 128, 4, (0.0, 1.0, 2.7), (0.0, 0.0, -1.0), 60.0,
                None),
    "hall": (40_000, 160, 90, 2, (2.5, 5.0, 5.0), (1.0, -0.12, 0.02),
             60.0, "inside"),
    "crown": (60_000, 160, 90, 2, (4.2, 1.8, 1.2), (-4.2, -1.4, -1.2),
              42.0, "above"),
    "mathall": (40_000, 160, 90, 2, (2.5, 5.0, 5.0), (1.0, -0.12, 0.02),
                60.0, "inside"),
}
TEST_ITERS = 2  # what the CI-budget test renders


def build_scene(name, tris, mpl=8):
    from rodent_tpu.render.compiler import compile_mesh, compile_obj
    from rodent_tpu.utils import testscenes
    if name == "cornell":
        return compile_obj(testscenes.CORNELL_OBJ, max_path_len=mpl)
    if name == "hall":
        verts, idx = testscenes.make_hall(tris)
        return compile_mesh(verts, idx, max_path_len=mpl,
                            emitter="inside")
    if name == "mathall":
        verts, idx = testscenes.make_hall(tris, rich_mats=True)
        mats, texs = testscenes.mat_hall_materials()
        return compile_mesh(verts, idx, max_path_len=mpl,
                            emitter="inside", materials=mats,
                            tex_images=texs)
    verts, idx = testscenes.make_crown(tris)
    return compile_mesh(verts, idx, max_path_len=mpl, emitter="above")


def render(scene, name, iters):
    """Tonemapped image after `iters` iterations of the production
    render policy for the default backend."""
    from rodent_tpu.render import film as film_mod
    from rodent_tpu.render.camera import Camera
    from rodent_tpu.render.compiler import select_render_policy
    from rodent_tpu.render.integrator import render_iteration_persistent
    tris, W, H, spp, eye, dirv, fov, _em = CONFIGS[name]
    cam = Camera.make(eye, dirv, (0, 1, 0), fov, W, H)
    policy = select_render_policy(scene.device)
    film = film_mod.new_film(W, H)
    for it in range(iters):
        film = render_iteration_persistent(scene.device, cam, film, W, H,
                                           spp, it, **policy)
    return film_mod.tonemap(film, W, H, iters)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "golden"))
    ap.add_argument("--scenes", default="cornell,hall,crown,mathall")
    args = ap.parse_args()

    from rodent_tpu.utils.compile import enable_compile_cache
    enable_compile_cache()
    from rodent_tpu.io import png
    from rodent_tpu.render import film as film_mod

    os.makedirs(args.out, exist_ok=True)
    meta_path = os.path.join(args.out, "golden_meta.json")
    meta = {}
    if os.path.exists(meta_path):
        meta = json.load(open(meta_path))

    for name in args.scenes.split(","):
        tris, W, H, spp, *_ = CONFIGS[name]
        scene = build_scene(name, tris)
        golden = np.asarray(render(scene, name, args.iters))
        short = np.asarray(render(scene, name, TEST_ITERS))
        mse = film_mod.mse_u8(golden, short)
        png.write_png(os.path.join(args.out, f"{name}.png"),
                      golden.astype(np.uint8))
        meta[name] = {"tris": tris, "w": W, "h": H, "spp": spp,
                      "golden_iters": args.iters,
                      "test_iters": TEST_ITERS,
                      "calib_mse_u8": round(float(mse), 2),
                      "mean_u8": round(float(golden.mean()), 2)}
        print(f"{name}: golden mean {golden.mean():.1f}, short-render "
              f"MSE {mse:.1f} (gate = 3x)", flush=True)
    json.dump(meta, open(meta_path, "w"), indent=1)
    print(f"wrote {meta_path}")


if __name__ == "__main__":
    main()
