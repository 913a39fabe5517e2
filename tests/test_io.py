"""I/O tests: PNG codec round trip + golden-image decode, OBJ/MTL loading of
the reference cornell box fixture, and .bvh/.rays/.fbuf round trips."""
import os

import numpy as np
import pytest

from rodent_tpu.io import formats, obj, png
from rodent_tpu.utils.testscenes import CORNELL_OBJ

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_png_roundtrip(tmp_path):
    img = (np.arange(48 * 32 * 3) % 251).astype(np.uint8).reshape(32, 48, 3)
    p = tmp_path / "t.png"
    png.write_png(p, img)
    got = png.read_png(p)
    np.testing.assert_array_equal(got, img)


def test_png_reads_reference_golden():
    """Decodes an in-repo golden written by the renderer's own encoder
    (tests/golden/hall.png, 160x90 RGB)."""
    img = png.read_png(os.path.join(GOLDEN, "hall.png"))
    assert img.ndim == 3 and img.shape[2] in (1, 2, 3, 4)
    assert img.shape[:2] == (90, 160)
    # a lit interior: nontrivial content
    assert int(img.max()) > 50 and int(img.min()) < int(img.max())


def test_obj_cornell_box():
    mesh, materials, mtl_lib = obj.load_scene_mesh(CORNELL_OBJ)
    # 18 quads split into 2 tris each: 5 walls + 6+6 box faces + light
    assert mesh.num_tris == 2 * (5 + 6 + 6 + 1)
    assert "light" in materials
    light = mtl_lib["light"]
    assert light.ke == (17.0, 12.0, 4.0)
    assert mtl_lib["leftWall"].kd == (0.63, 0.065, 0.05)
    # material ids in range, 4-int index convention
    assert mesh.indices.shape[0] == mesh.num_tris * 4
    assert mesh.tri_materials.min() >= 0
    assert mesh.tri_materials.max() < len(materials)
    # face normals unit length
    np.testing.assert_allclose(
        np.linalg.norm(mesh.face_normals, axis=-1), 1.0, atol=1e-5)
    # smooth normals unit length
    np.testing.assert_allclose(
        np.linalg.norm(mesh.normals, axis=-1), 1.0, atol=1e-5)
    # the floor quad lies at y=0: its two triangles' normals point up
    v = mesh.vertices[mesh.tri_indices[0]]
    assert abs(v[:, 1]).max() < 1e-6
    assert abs(abs(mesh.face_normals[0, 1]) - 1.0) < 1e-6


def test_bvh_file_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    nodes = np.zeros(3, formats.node_dtype(8))
    nodes["bounds"] = rng.randn(3, 6, 8).astype(np.float32)
    nodes["child"] = rng.randint(-5, 5, (3, 8)).astype(np.int32)
    tris = np.zeros(2, formats.TRI4_DTYPE)
    tris["v0"] = rng.randn(2, 3, 4).astype(np.float32)
    tris["prim_id"] = np.asarray([[0, 1, 2, 3], [4, -1, -1, -0x80000000]], np.int32)
    p = tmp_path / "t.bvh"
    formats.write_bvh(p, formats.BvhBlock(formats.BVH8_TRI4, nodes, tris))
    blk = formats.read_bvh(p, formats.BVH8_TRI4)
    assert blk.arity == 8
    np.testing.assert_array_equal(blk.nodes["bounds"], nodes["bounds"])
    np.testing.assert_array_equal(blk.tris["prim_id"], tris["prim_id"])


def test_bvh_multiblock_seek(tmp_path):
    n4 = np.zeros(1, formats.node_dtype(4))
    n8 = np.zeros(2, formats.node_dtype(8))
    t = np.zeros(1, formats.TRI4_DTYPE)
    p = tmp_path / "m.bvh"
    formats.write_bvh(p, [
        formats.BvhBlock(formats.BVH4_TRI4, n4, t),
        formats.BvhBlock(formats.BVH8_TRI4, n8, t),
    ])
    blk = formats.read_bvh(p, formats.BVH8_TRI4)
    assert len(blk.nodes) == 2
    blk = formats.read_bvh(p, formats.BVH4_TRI4)
    assert len(blk.nodes) == 1
    with pytest.raises(KeyError):
        formats.read_bvh(p, formats.BVH2_TRI1)


def test_rays_roundtrip(tmp_path):
    org = np.random.randn(17, 3).astype(np.float32)
    d = np.random.randn(17, 3).astype(np.float32)
    p = tmp_path / "t.rays"
    formats.write_rays(p, org, d)
    rays = formats.read_rays(p, tmin=0.01, tmax=5000.0)
    np.testing.assert_array_equal(rays["org"], org)
    np.testing.assert_array_equal(rays["dir"], d)
    assert rays["tmin"][0] == np.float32(0.01)
    assert rays["tmax"][0] == np.float32(5000.0)


def test_fbuf_roundtrip(tmp_path):
    vals = np.random.rand(64).astype(np.float32)
    p = tmp_path / "t.fbuf"
    formats.write_fbuf(p, vals)
    np.testing.assert_array_equal(formats.read_fbuf(p), vals)
    img = formats.fbuf_to_png_array(vals, 8, 8, normalize=True)
    assert img.shape == (8, 8) and img.max() == 255


def test_native_obj_loader_matches_python():
    """The C++ loader (native/obj_loader.cpp) must reproduce the Python
    twin's TriMesh on cornell: identical vertices/indices/texcoords and
    material tables; normals within 1 ulp (numpy's cross/norm order)."""
    from rodent_tpu import native
    from rodent_tpu.io.obj import load_scene_mesh
    if not native.available():
        pytest.skip("native library unavailable")
    path = CORNELL_OBJ
    out = native.obj_load(path)
    assert out is not None
    verts, norms, texs, fnorm, idx, names, libs = out
    mesh, pnames, _ = load_scene_mesh(path, prefer_native=False)
    np.testing.assert_array_equal(verts, mesh.vertices)
    np.testing.assert_array_equal(idx, mesh.indices)
    np.testing.assert_array_equal(texs, mesh.texcoords)
    np.testing.assert_allclose(norms, mesh.normals, atol=2e-7)
    np.testing.assert_allclose(fnorm, mesh.face_normals, atol=2e-7)
    assert names == pnames
    assert libs == ["cornell_box.mtl"]
    # and the dispatching wrapper picks the native path
    mesh2, names2, mtl = load_scene_mesh(path)
    np.testing.assert_array_equal(mesh2.vertices, verts)
    assert "light" in mtl or len(mtl) > 0


def test_cornell_fixture_matches_generator(tmp_path):
    """tests/fixtures/cornell_box.{obj,mtl} are exactly what
    utils.testscenes writes, and its layout is the classic box the
    reference camera expects."""
    from rodent_tpu.utils import testscenes
    testscenes.write_cornell_box(str(tmp_path))
    for name in ("cornell_box.obj", "cornell_box.mtl"):
        with open(os.path.join(testscenes.FIXTURE_DIR, name)) as a, \
                open(tmp_path / name) as b:
            assert a.read() == b.read(), name
    mesh, _, _ = obj.load_scene_mesh(CORNELL_OBJ)
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    np.testing.assert_allclose(lo, [-1, 0, -1])
    np.testing.assert_allclose(hi, [1, 2, 1])
