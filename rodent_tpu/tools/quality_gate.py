"""quality_gate: the reference's ctest golden-image check as one CLI.

Mirrors cmake/test/run_rodent.cmake: renders cornell at the fixed ctest
camera (eye (0, 1, 2.7), looking -z, fov 60) and prints the MSE against a
golden image so CI can gate on it. The reference's ref-cornell.png is not
redistributable, so the default fixture is the in-repo Cornell box
(tests/fixtures, utils.testscenes.write_cornell_box) and the default
golden is its converged film made by experiments/make_goldens.py
(tests/golden/cornell.png): the gate catches regressions of this
renderer against itself, not differences from the reference renderer.

Monte-Carlo noise decays as 1/N, so MSE(N) ~ c * (1/N + 1/G) for a
golden of G iterations; c comes from the golden's calibration in
tests/golden/golden_meta.json, and the default threshold is 3x that
curve plus one u8^2.

Usage:
  python -m rodent_tpu.tools.quality_gate [--iters 50] [--threshold MSE]
      [--scene OBJ] [--ref PNG] [-o out.png] [--cpu] [--fast]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..utils.testscenes import CORNELL_OBJ, FIXTURE_DIR

GOLDEN_DIR = os.path.join(os.path.dirname(FIXTURE_DIR), "golden")


def default_threshold(iters, meta_path=os.path.join(GOLDEN_DIR,
                                                     "golden_meta.json")):
    """3x the calibrated noise curve c * (1/iters + 1/G), plus 1."""
    m = json.load(open(meta_path))["cornell"]
    g, k = m["golden_iters"], m["test_iters"]
    c = m["calib_mse_u8"] / (1.0 / k + 1.0 / g)
    return 3.0 * c * (1.0 / iters + 1.0 / g) + 1.0


def main(argv=None):
    p = argparse.ArgumentParser(prog="quality_gate")
    p.add_argument("--scene", default=CORNELL_OBJ)
    p.add_argument("--ref", default=os.path.join(GOLDEN_DIR, "cornell.png"))
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--threshold", type=float, default=None,
                   help="max allowed MSE on u8 values; default 3x the "
                        "calibrated noise curve of the golden")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="half resolution + downsampled reference "
                        "(CI-friendly)")
    p.add_argument("--checkpoints", default="",
                   help="comma list of iteration counts at which to "
                        "record MSE (convergence curve: noise decays "
                        "~1/N toward the golden's own noise floor; a "
                        "plateau above it would mean estimator bias)")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from ..utils.compile import enable_compile_cache
        enable_compile_cache()
    from ..io import png
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_obj, select_render_policy
    from ..render.integrator import render_iteration_persistent

    ref = png.read_png(args.ref)[..., :3]
    H0, W0 = ref.shape[:2]
    if args.fast:
        W, H = W0 // 2, H0 // 2
        ref = ref[:H * 2, :W * 2].reshape(H, 2, W, 2, 3).mean((1, 3))
    else:
        W, H = W0, H0

    scene = compile_obj(args.scene, max_path_len=8)
    policy = select_render_policy(scene.device)
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    film = film_mod.new_film(W, H)
    checkpoints = sorted(int(t) for t in args.checkpoints.split(",") if t)
    iters = max([args.iters] + checkpoints)
    if args.threshold is None:
        args.threshold = default_threshold(iters)
    t0 = time.time()
    for it in range(iters):
        film = render_iteration_persistent(scene.device, cam, film, W, H,
                                           args.spp, it, **policy)
        if it + 1 in checkpoints:
            img_c = film_mod.tonemap(film, W, H, it + 1)
            print(f"checkpoint {it + 1:5d} iters "
                  f"({(it + 1) * args.spp} spp): "
                  f"MSE={film_mod.mse_u8(ref, img_c):.3f}", flush=True)
    jax.block_until_ready(film)
    img = film_mod.tonemap(film, W, H, iters)
    if args.output:
        png.write_png(args.output, img)

    mse = film_mod.mse_u8(ref, img)
    mad = float(np.mean(np.abs(ref.astype(np.float64)
                               - img.astype(np.float64))))
    msamp = W * H * args.spp * iters / (time.time() - t0) / 1e6
    print(f"cornell {W}x{H}, {iters} iters x {args.spp} spp: "
          f"MSE={mse:.2f} mean|diff|={mad:.2f}/255 ({msamp:.2f} Msamples/s)")
    if mse > args.threshold:
        print(f"FAIL: MSE {mse:.2f} > threshold {args.threshold}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
