"""Round-2 parity sweep: camera project/unproject/geometry, light
sample_emission, and the debug renderer (VERDICT r1 'missing #5')."""
import numpy as np
import jax.numpy as jnp
import pytest

from rodent_tpu.render.camera import Camera
from rodent_tpu.render import light as light_mod
from rodent_tpu.utils.testscenes import CORNELL_OBJ


@pytest.fixture(scope="module")
def cam():
    return Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, 64, 48)


def test_camera_project_inverts_generate(cam):
    """project(generate_ray(kx, ky).org + t*dir) == (kx, ky, -z<0)
    (camera.impala:44-49 vs :36-42)."""
    kx = jnp.asarray([0.0, 0.5, -0.8, 0.3])
    ky = jnp.asarray([0.0, -0.4, 0.7, 0.9])
    org, d = cam.generate_rays(kx, ky)
    p = np.asarray(cam.project(org + 3.0 * d))
    assert np.all(p[:, 2] < 0)  # -dot(d, view_dir), d toward the scene
    # the reference returns pre-divide coordinates: x/(-z) is the NDC kx
    np.testing.assert_allclose(p[:, 0] / -p[:, 2], np.asarray(kx),
                               atol=1e-5)
    np.testing.assert_allclose(p[:, 1] / -p[:, 2], np.asarray(ky),
                               atol=1e-5)


def test_camera_unproject_is_eye(cam):
    """A pinhole's unprojection is the eye (camera.impala:50)."""
    out = cam.unproject(jnp.zeros((5, 3)))
    np.testing.assert_array_equal(np.asarray(out),
                                  np.tile(np.asarray(cam.eye, np.float32),
                                          (5, 1)))


def test_camera_geometry(cam):
    """CameraGeometry: dist = sqrt(1 + (xw)^2 + (yh)^2), cos = 1/dist,
    area = 1/(4wh) (camera.impala:51-54)."""
    g = cam.geometry(jnp.asarray([0.0, 1.0]), jnp.asarray([0.0, -1.0]))
    d = np.asarray(g["dist"])
    assert d[0] == pytest.approx(1.0)
    assert d[1] == pytest.approx(
        np.sqrt(1.0 + cam.w ** 2 + cam.h ** 2), rel=1e-6)
    np.testing.assert_allclose(np.asarray(g["cos_dir"]), 1.0 / d, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g["area"]),
                               1.0 / (4 * cam.w * cam.h), rtol=1e-6)


def _unit_tri_table():
    return {
        "kind": jnp.asarray([light_mod.TRIANGLE]),
        "v0": jnp.asarray([[0.0, 0.0, 0.0]]),
        "v1": jnp.asarray([[1.0, 0.0, 0.0]]),
        "v2": jnp.asarray([[0.0, 1.0, 0.0]]),
        "n": jnp.asarray([[0.0, 0.0, 1.0]]),
        "inv_area": jnp.asarray([2.0]),
        "color": jnp.asarray([[3.0, 2.0, 1.0]]),
    }


def test_sample_emission_triangle():
    """Triangle light emission samples lie on the triangle, point into the
    normal's hemisphere, carry pdf_area=inv_area and the cosine pdf
    (make_area_light sample_emission, light.impala:131-134)."""
    table = _unit_tri_table()
    n = 512
    idx = jnp.zeros((4, 128), jnp.int32)
    rnd = jnp.arange(1, n + 1, dtype=jnp.uint32).reshape(4, 128)
    es, _ = light_mod.sample_emission(table, idx, rnd)
    x, y, z = [np.asarray(c).ravel() for c in es["pos"]]
    assert np.all(z == 0) and np.all(x >= -1e-6) and np.all(y >= -1e-6)
    assert np.all(x + y <= 1 + 1e-5)
    dz = np.asarray(es["dir"][2]).ravel()
    assert np.all(dz > 0)  # cosine hemisphere about +z
    np.testing.assert_allclose(np.asarray(es["cos"]).ravel(), dz,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(es["pdf_area"]).ravel(), 2.0)
    np.testing.assert_allclose(np.asarray(es["pdf_dir"]).ravel(),
                               dz / np.pi, rtol=2e-5)
    for c, want in zip(es["intensity"], (3.0, 2.0, 1.0)):
        np.testing.assert_allclose(np.asarray(c).ravel(), want)


def test_sample_emission_point():
    """Point light: dir ~ uniform sphere (pdf 1/4pi), intensity
    color/(4pi), pdf_area 1 (light.impala:110-116)."""
    table = {
        "kind": jnp.asarray([light_mod.POINT]),
        "v0": jnp.asarray([[1.0, 2.0, 3.0]]),
        "v1": jnp.zeros((1, 3)), "v2": jnp.zeros((1, 3)),
        "n": jnp.asarray([[0.0, 0.0, 1.0]]),
        "inv_area": jnp.ones(1),
        "color": jnp.asarray([[4.0 * np.pi, 0.0, 0.0]]),
    }
    idx = jnp.zeros((2, 128), jnp.int32)
    rnd = jnp.arange(7, 263, dtype=jnp.uint32).reshape(2, 128)
    es, _ = light_mod.sample_emission(table, idx, rnd)
    for c, want in zip(es["pos"], (1.0, 2.0, 3.0)):
        assert np.allclose(np.asarray(c), want)
    norm = np.sqrt(sum(np.asarray(c) ** 2 for c in es["dir"]))
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(es["pdf_dir"]),
                               1.0 / (4 * np.pi), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(es["pdf_area"]), 1.0)
    np.testing.assert_allclose(np.asarray(es["intensity"][0]), 1.0,
                               rtol=1e-6)


def test_debug_renderer_cornell():
    """Eye-light image: finite, grayscale, walls visible, in [0, 1]
    (make_debug_renderer, renderer.impala:42-60)."""
    from rodent_tpu.render.compiler import compile_obj
    from rodent_tpu.render.integrator import render_debug
    from rodent_tpu.render import film as film_mod

    W, H = 64, 48
    scene = compile_obj(CORNELL_OBJ,
                        max_path_len=4)
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    film = film_mod.new_film(W, H)
    film = render_debug(scene.device, cam, film, W, H, 0)
    img = np.asarray(film).reshape(H, W, 3)
    assert np.isfinite(img).all()
    assert np.all(img >= 0) and np.all(img <= 1 + 1e-5)
    # grayscale (white * cos)
    np.testing.assert_allclose(img[..., 0], img[..., 1], atol=1e-6)
    np.testing.assert_allclose(img[..., 0], img[..., 2], atol=1e-6)
    # the camera looks straight at the back wall: center is lit
    assert img[H // 2, W // 2, 0] > 0.5
