"""End-to-end path-tracer tests on the cornell box fixture.

The reference's quality gate renders cornell with --eye 0 1 2.7 --dir 0 0 -1
(default 1080x720, fov 60, spp 4) for 50 iterations and MSE-compares
against testing/ref-cornell.png (cmake/test/run_rodent.cmake). That image
cannot be redistributed, so the fixture is the in-repo Cornell box
(tests/fixtures) and the golden is this renderer's own converged film of
it (tests/golden/cornell.png, experiments/make_goldens.py): the
comparison catches regressions, not differences from the reference
renderer. Here we render a small image on CPU and check physical
properties + a loose comparison against the downsampled golden.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from rodent_tpu.io import png
from rodent_tpu.render.camera import Camera
from rodent_tpu.render.compiler import compile_obj
from rodent_tpu.render import film as film_mod
from rodent_tpu.render.integrator import render_iteration
from rodent_tpu.utils.testscenes import CORNELL_OBJ

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell.png")
W, H = 96, 64


@pytest.fixture(scope="module")
def cornell():
    return compile_obj(CORNELL_OBJ, max_path_len=8)


@pytest.fixture(scope="module")
def cornell_img(cornell):
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    film = film_mod.new_film(W, H)
    iters = 4
    for i in range(iters):
        film = render_iteration(cornell.device, cam, film, W, H, 4, i)
    return film_mod.tonemap(film, W, H, iters), np.asarray(film)


def test_scene_compile(cornell):
    # cleanup_obj dedups identical materials: the five white walls/boxes
    # collapse into one, leaving floor/rightWall/leftWall/light
    assert cornell.num_lights == 2  # light quad = 2 triangles
    assert len(cornell.materials) == 4
    dev = cornell.device
    assert int(dev["indices"].shape[0]) == 36
    # light_ids nonzero only for the light quad's triangles
    lids = np.asarray(dev["light_ids"])
    assert (lids != 0).sum() == 1  # ids are 0-based; one tri has id 1
    emissive = np.asarray(dev["mat_table"]["emissive"])
    assert emissive.sum() == 1


def test_render_finite_and_lit(cornell_img):
    img, raw = cornell_img
    assert np.isfinite(raw).all()
    assert raw.min() >= 0.0
    # image must not be black or constant
    assert img.mean() > 10
    assert img.std() > 10


def test_render_colors(cornell_img):
    img, _ = cornell_img
    h, w, _ = img.shape
    # left wall red-dominant, right wall green-dominant
    left = img[h // 2, 2:6].mean(axis=0).astype(np.int32)
    right = img[h // 2, -6:-2].mean(axis=0).astype(np.int32)
    assert left[0] > left[1] + 10 and left[0] > left[2] + 10
    assert right[1] > right[0] + 10 and right[1] > right[2] + 10
    # ceiling light region is saturated white-ish
    light = img[2:5, w // 2 - 4:w // 2 + 4].mean(axis=(0, 1))
    assert light[0] > 240


def test_render_against_downsampled_golden(cornell_img):
    img, _ = cornell_img
    ref = png.read_png(GOLDEN)[..., :3]
    # box-downsample the golden to our render size
    fh, fw = ref.shape[0] // H, ref.shape[1] // W
    ref_small = ref[:fh * H, :fw * W].reshape(H, fh, W, fw, 3).mean((1, 3))
    diff = np.abs(ref_small - img.astype(np.float64))
    # loose gate: low-spp noise + downsample blur allow ~5% mean error
    assert diff.mean() < 14.0, f"mean abs diff {diff.mean():.2f}"


def test_tri_shade_matches_four_gather_path(cornell):
    """The pre-joined tri_shade single-gather surface element must give a
    bit-identical film to the memory-lean 4-gather path (tri_geo +
    3x vtx_geo) it replaces on small scenes."""
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    dev_lean = dict(cornell.device)
    dev_lean.pop("tri_shade")
    films = []
    for dev in (cornell.device, dev_lean):
        film = film_mod.new_film(W, H)
        film = render_iteration(dev, cam, film, W, H, 2, 0)
        films.append(np.asarray(film))
    np.testing.assert_array_equal(films[0], films[1])


def test_persistent_matches_progressive(cornell):
    """The persistent-wavefront (megakernel-regeneration analog) must
    produce a bit-identical film: RNG streams depend only on
    (sample, iter, x, y), not on slot scheduling."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    from rodent_tpu.render.integrator import render_iteration as ri
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 24, 16)
    f1 = ri(cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0)
    f2 = render_iteration_persistent(
        cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0,
        pool=256)  # pool < total: forces regeneration
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f1),
                               rtol=1e-5, atol=1e-6)


def test_walk_render_matches(cornell):
    """Rendering with the per-ray walk kernel (Pallas interpreter on the
    CPU) matches the XLA-traversal film (same RNG streams)."""
    from rodent_tpu.render.integrator import render_iteration as ri
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 16, 16)
    f1 = ri(cornell.device, cam, film_mod.new_film(16, 16), 16, 16, 1, 0)
    f2 = ri(cornell.device, cam, film_mod.new_film(16, 16), 16, 16, 1, 0,
            engine="walk-interpret")
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f1),
                               rtol=1e-5, atol=1e-6)


def test_sorted_traversal_matches(cornell):
    """sort=True (per-step wavefront re-sort before traversal, the
    reference's every-bounce sort_rays — mapping_cpu.impala:409) must be
    a pure reordering: hits scatter back to slot order, so films are
    bit-identical for both traversal engines."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 24, 16)

    def run(engine, sort):
        return np.asarray(render_iteration_persistent(
            cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0,
            pool=256, engine=engine, sort=sort))

    base = run("tiled", False)
    np.testing.assert_array_equal(run("tiled", True), base)
    np.testing.assert_array_equal(run("walk-interpret", True),
                                  run("walk-interpret", False))


def test_traversal_policies_agree(cornell):
    """Every traversal engine must produce the same film up to float
    reassociation noise across separately-compiled kernels."""
    from rodent_tpu.render.integrator import render_sample
    scene = cornell
    w, h = 24, 16
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, w, h)
    film0 = jnp.zeros((w * h, 3), jnp.float32)
    films = [np.asarray(render_sample(scene.device, cam, film0, w, h, 0, 0,
                                      engine=eng))
             for eng in ("tiled", "dense", "walk-interpret")]
    for f in films[1:]:
        np.testing.assert_allclose(f, films[0], atol=1e-5, rtol=1e-5)


def test_dense_persistent_film_matches(cornell):
    """The dense engine (small-scene brute-force traversal) runs the same
    Moller-Trumbore as the BVH engines, so the persistent renderer's
    film must match the tiled-traversal film on cornell up to FMA-
    contraction ULP noise — and the CPU engine choice must pick it for
    cornell-class scenes."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    from rodent_tpu.traversal.engine import select_engine
    assert select_engine(cornell.device["bvh"], "cpu") == "dense"
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 24, 16)

    def run(engine):
        return np.asarray(render_iteration_persistent(
            cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0,
            pool=256, engine=engine))

    np.testing.assert_allclose(run("dense"), run("tiled"),
                               rtol=1e-5, atol=1e-5)


def test_deferred_retirement_film_bit_identical(cornell):
    """retire_every=K batches the splat+regeneration block every K steps
    (dead slots idle in between). Samples are keyed by id, not by slot
    or step, so the film must be bit-identical for any K — including
    pools smaller than the sample count (regeneration active) and the
    all-dead mid-cycle forced retirement."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 24, 16)

    def run(k):
        return np.asarray(render_iteration_persistent(
            cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0,
            pool=256, retire_every=k))

    base = run(1)
    for k in (2, 5):
        np.testing.assert_array_equal(run(k), base)


def test_pool_sort_film_bit_identical(cornell):
    """sort="pool" permutes the pool itself at each retirement (slot
    identity carries pixel/acc/sample), so the film must be bit-identical
    to the unsorted run — including with deferred retirement, regeneration
    active, and pool padding (pool=200 is not a multiple of 128, so real
    slots move across the padding boundary when permuted)."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 24, 16)

    def run(sort, k=1):
        return np.asarray(render_iteration_persistent(
            cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0,
            pool=200, sort=sort, retire_every=k))

    base = run(False)
    np.testing.assert_array_equal(run("pool"), base)
    np.testing.assert_array_equal(run("pool", k=3), base)


def test_sub_batch_film_bit_identical(cornell):
    """sub=k chunks the tiled engine's traversals into sequential lax.map
    sub-batches (lockstep-tail bound); chunking changes the
    loop schedule, never the per-ray result, so the film must be
    bit-identical — including under pool-sort and with a pool wide
    enough for the split to engage (pool=2048 -> 16 rows, sub=2 ->
    8-row chunks, the minimum)."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 64, 32)

    def run(**kw):
        return np.asarray(render_iteration_persistent(
            cornell.device, cam, film_mod.new_film(64, 32), 64, 32, 2, 0,
            pool=2048, engine="tiled", compact=3, **kw))

    base = run()
    np.testing.assert_array_equal(run(sub=2), base)
    np.testing.assert_array_equal(run(sub=2, sort="pool"),
                                  run(sort="pool"))


def test_pool_rule_from_enclosure():
    """select_render_policy derives the pool size from the
    shell_coverage enclosure statistic instead of hardcoding per scene
    (enclosed hall gets 64K, open crown the default 32K)."""
    from rodent_tpu.render.compiler import (compile_mesh,
                                            select_render_policy,
                                            shell_coverage)
    from rodent_tpu.utils.testscenes import make_crown, make_hall
    v, i = make_hall(20_000)
    hall = compile_mesh(v, i)
    v, i = make_crown(20_000)
    crown = compile_mesh(v, i)
    assert shell_coverage(hall.device) >= 0.5
    assert shell_coverage(crown.device) < 0.2
    assert select_render_policy(hall.device).get("pool") == 1 << 16
    assert "pool" not in select_render_policy(crown.device)


def test_engine_routing_film_identical(cornell):
    """Which engine serves the bounce and shadow traversals changes
    which (exact-parity) kernel traces a ray, never the estimator: every
    engine gives the SAME film, including with pool-sort and deferred
    retirement. Engines differ from the compiled tiled loop by
    FMA-contraction ULPs in t/u/v (the dense-engine caveat), so this
    test allows ULP-level tolerance."""
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 24, 16)

    def run(**kw):
        return np.asarray(render_iteration_persistent(
            cornell.device, cam, film_mod.new_film(24, 16), 24, 16, 2, 0,
            pool=200, **kw))

    base = run(engine="tiled")
    for kw in (dict(engine="tiled", compact=2, sort="pool"),
               dict(engine="dense", sort="pool", retire_every=2),
               dict(engine="walk-interpret"),
               dict(engine="walk-interpret", sort="pool",
                    retire_every=2)):
        np.testing.assert_allclose(run(**kw), base, rtol=2e-6, atol=2e-7)
