"""The full-MTL procedural bench scene (mathall).

The reference's renderer bench runs six full-MTL interiors mixing
textured, specular, glass and mirror shaders
(benchmarks/bench.sh:9-85; shader emission
converter.cpp:859-927); the plain procedural bench scenes here are
palette-diffuse, so mathall (make_hall(rich_mats=True) +
mat_hall_materials via compile_mesh's materials/tex_images extension)
is the scene that times every BSDF kind at scale. These tests pin its
compile-time structure and a small end-to-end render on CPU.
"""
import numpy as np
import pytest

from rodent_tpu.render import film as film_mod
from rodent_tpu.render.camera import Camera
from rodent_tpu.render.compiler import compile_mesh
from rodent_tpu.render import bsdf
from rodent_tpu.render.integrator import render_iteration_persistent
from rodent_tpu.utils.testscenes import make_hall, mat_hall_materials

W, H = 72, 48


@pytest.fixture(scope="module")
def mathall():
    verts, idx = make_hall(6000, rich_mats=True)
    mats, texs = mat_hall_materials()
    return compile_mesh(verts, idx, max_path_len=6, emitter="inside",
                        materials=mats, tex_images=texs)


def test_mathall_uses_every_bsdf_kind(mathall):
    # the whole point of the scene: one interior exercising BLACK..MIX
    kinds = set(mathall.device["mat_kinds"].kinds)
    assert {bsdf.DIFFUSE, bsdf.PHONG, bsdf.MIRROR, bsdf.GLASS,
            bsdf.MIX} <= kinds
    kd_tex = np.asarray(mathall.device["mat_table"]["kd_tex"])
    assert (kd_tex >= 0).sum() == 2          # checker floor + plaster
    assert mathall.device["textures"].shape[0] == 2
    # triplanar UVs generated (procedural geometry ships none)
    uv = np.asarray(mathall.device["texcoords"])
    assert np.abs(uv).max() > 0.5


def test_mathall_renders_lit_and_finite(mathall):
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0),
                      60.0, W, H)
    film = film_mod.new_film(W, H)
    iters = 2
    for i in range(iters):
        film = render_iteration_persistent(mathall.device, cam, film,
                                           W, H, 1, i, engine="tiled",
                                           compact=0)
    raw = np.asarray(film)
    assert np.isfinite(raw).all() and raw.min() >= 0.0
    img = film_mod.tonemap(film, W, H, iters)
    a = np.asarray(img)
    assert a.mean() > 5 and a.std() > 5      # lit, non-constant
    assert (a > 0).mean() > 0.4              # most pixels receive light
