"""Golden-image gates for the procedural bench scenes.

The reference pins its renderer with MSE golden-image ctests
(cmake/test/run_rodent.cmake vs testing/ref-cornell.png). A
cross-engine check alone would pass a regression that shifts every
engine equally, so every scene here, cornell included (the in-repo
fixture, whose golden is this renderer's own converged film — the
reference image is not redistributable), has one. tests/golden/*.png are converged films produced by
experiments/make_goldens.py (fixed scene/camera/spp config recorded in
golden_meta.json); each test renders the CI-budget iteration count and
gates at 3x the creation-time calibrated Monte-Carlo noise MSE.
"""
import json
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
META = os.path.join(GOLDEN_DIR, "golden_meta.json")

pytestmark = pytest.mark.skipif(
    not os.path.exists(META), reason="goldens not generated yet")


def _meta():
    return json.load(open(META))


@pytest.mark.parametrize("name", ["hall", "crown", "mathall", "cornell"])
def test_scene_matches_golden(name):
    meta = _meta()
    if name not in meta:
        pytest.skip(f"no golden for {name}")
    m = meta[name]
    from rodent_tpu.io import png
    from rodent_tpu.render import film as film_mod
    from experiments.make_goldens import build_scene, render

    golden = png.read_png(
        os.path.join(GOLDEN_DIR, f"{name}.png"))[..., :3]
    scene = build_scene(name, m["tris"])
    img = np.asarray(render(scene, name, m["test_iters"]))
    mse = film_mod.mse_u8(golden, img)
    # 3x the creation-time short-render MSE: catches exposure/geometry/
    # estimator regressions while absorbing MC noise + platform float
    # scheduling differences
    assert mse <= 3.0 * m["calib_mse_u8"] + 1.0, (
        f"{name}: MSE {mse:.1f} vs calibrated {m['calib_mse_u8']:.1f}")
    # and the film is lit in the same exposure range
    assert abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"]
