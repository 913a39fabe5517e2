"""CLI tool tests: ray_gen -> bvh_extractor -> bench_traversal -> fbuf2png
pipeline on the cornell fixture, plus converter data/ round trip — the
reference's ctest traversal flow (cmake/test/run_traversal.cmake)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rodent_tpu.io import formats, png
from rodent_tpu.utils.testscenes import CORNELL_OBJ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(mod, *args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", f"rodent_tpu.tools.{mod}", *map(str, args)],
        capture_output=True, text=True, cwd=ROOT, env=env)
    assert r.returncode == 0, f"{mod} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def test_full_traversal_pipeline(tmp_path):
    rays_f = tmp_path / "cam.rays"
    bvh_f = tmp_path / "cornell.bvh"
    fbuf_f = tmp_path / "out.fbuf"
    png_f = tmp_path / "out.png"

    out = run_tool("ray_gen", "primary", 0, 1, 2.7, 0, 0, -1, 0, 1, 0,
                   60, 64, 48, rays_f)
    assert "3072 rays" in out
    out = run_tool("bvh_extractor", CORNELL_OBJ, bvh_f,
                   "--width", 8, "--width", 4)
    assert "BVH8" in out and "BVH4" in out
    out = run_tool("bench_traversal", "-bvh", bvh_f, "-ray", rays_f,
                   "--tmin", 0.01, "--tmax", 5000, "--bench", 2,
                   "-o", fbuf_f, "--cpu")
    assert "Mrays/sec" in out
    # every primary ray hits inside the closed box
    assert "3072 intersection(s)" in out
    t = formats.read_fbuf(fbuf_f)
    assert len(t) == 3072 and (t > 0.5).all() and (t < 10).all()

    run_tool("fbuf2png", "-n", "-sx", 64, "-sy", 48, fbuf_f, png_f)
    img = png.read_png(png_f)
    assert img.shape == (48, 64, 4)
    assert img[..., 0].std() > 5  # depth variation visible

    # bvh4 and bvh8 blocks must give identical hit distances
    fbuf4 = tmp_path / "out4.fbuf"
    run_tool("bench_traversal", "-bvh", bvh_f, "-ray", rays_f,
             "--tmin", 0.01, "--tmax", 5000, "--bvh-width", 4,
             "-o", fbuf4, "--cpu")
    t4 = formats.read_fbuf(fbuf4)
    np.testing.assert_allclose(t4, t, rtol=1e-5, atol=1e-5)


def test_converter_roundtrip(tmp_path):
    from rodent_tpu.tools.converter import read_bvh_bin, write_scene_data
    data = tmp_path / "data"
    program = write_scene_data(CORNELL_OBJ, str(data))
    assert program["num_lights"] == 2
    assert (data / "scene.json").exists()
    verts = formats.read_lz4_buffer(data / "vertices.bin",
                                    np.float32).reshape(-1, 3)
    idx = formats.read_lz4_buffer(data / "indices.bin",
                                  np.int32).reshape(-1, 4)
    assert len(idx) == 36
    assert idx[:, :3].max() < len(verts)
    light_ids = formats.read_lz4_buffer(data / "light_ids.bin", np.int32)
    assert (light_ids != 0).sum() == 1
    nodes, tris = read_bvh_bin(data / "bvh.bin")
    assert len(nodes) >= 1 and len(tris) >= 9
    info = json.loads((data / "scene.json").read_text())
    assert any(m["emissive"] for m in info["materials"])


def test_render_tool_bench_output(tmp_path):
    out_png = tmp_path / "cornell.png"
    out = run_tool("render", CORNELL_OBJ, "--width", 48,
                   "--height", 32, "--eye", 0, 1, 2.7, "--dir", 0, 0, -1,
                   "--bench", 2, "--spp", 1, "--max-path-len", 4,
                   "-o", out_png, "--cpu", "--profile")
    assert "(min/med/max Msamples/s)" in out
    # --profile: the cpu_profile exit report (stage ms + percentages)
    assert "compile+render" in out and "tonemap" in out
    assert "Msamples/s" in out.splitlines()[-1]
    img = png.read_png(out_png)
    assert img.shape == (32, 48, 3)
    assert img.mean() > 5


def test_render_tool_sort_and_sharded_paths(tmp_path):
    """--sort must reach every loop variant (it was silently ignored under
    --progressive/--sharded), and all three loop variants must produce the
    bit-identical film (RNG seeds depend only on sample/iter/pixel)."""
    common = (CORNELL_OBJ, "--width", 48, "--height", 32,
              "--eye", 0, 1, 2.7, "--dir", 0, 0, -1, "--bench", 1,
              "--spp", 1, "--max-path-len", 4, "--cpu")
    a = tmp_path / "prog.png"
    run_tool("render", *common, "--progressive", "--sort", "on", "-o", a)
    b = tmp_path / "shard.png"
    run_tool("render", *common, "--sharded", "--sort", "on", "-o", b)
    c = tmp_path / "shard_prog.png"
    run_tool("render", *common, "--sharded", "--progressive", "--sort",
             "on", "-o", c)
    ia, ib, ic = (png.read_png(p) for p in (a, b, c))
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ib, ic)


@pytest.mark.parametrize("platform,engine", [
    ("cpu", "tiled"), ("gpu", "walk")])
def test_render_policy_per_platform(platform, engine):
    """select_render_policy takes its engine from the backend: the XLA
    engines on the CPU (tiled + staged compaction for BVH scenes), the
    walk kernel on the GPU; enclosed interiors get the 64K pool on both.
    Table sizes are faked with broadcast views."""
    from rodent_tpu.render.compiler import select_render_policy
    from rodent_tpu.utils.testscenes import make_hall
    from rodent_tpu.render.compiler import compile_mesh
    v, i = make_hall(4_000)
    hall = compile_mesh(v, i)
    pol = select_render_policy(hall.device, platform=platform)
    assert pol["engine"] == engine
    assert pol["pool"] == 1 << 16
    assert ("compact" in pol) == (engine == "tiled")


def test_checkpoint_resume(tmp_path):
    from rodent_tpu.utils.checkpoint import (
        build_bvh_cached, load_render_checkpoint, save_render_checkpoint)
    film = np.random.rand(64, 3).astype(np.float32)
    p = tmp_path / "ckpt.npz"
    save_render_checkpoint(p, film, 7, scene="cornell", spp=4)
    f2, it, meta = load_render_checkpoint(p)
    np.testing.assert_array_equal(f2, film)
    assert it == 7 and meta["scene"] == "cornell"

    # BVH cache: second build loads from disk and traverses identically
    from rodent_tpu.io import obj as obj_io
    mesh, _, _ = obj_io.load_scene_mesh(CORNELL_OBJ)
    b1 = build_bvh_cached(mesh.vertices, mesh.indices,
                          cache_dir=str(tmp_path / "cache"))
    b2 = build_bvh_cached(mesh.vertices, mesh.indices,
                          cache_dir=str(tmp_path / "cache"))
    np.testing.assert_array_equal(b1.child, b2.child)
    np.testing.assert_array_equal(b1.bounds, b2.bounds)
    assert len(list((tmp_path / "cache").glob("*.bvh"))) == 1


def test_load_data_dir_matches_compile_obj(tmp_path):
    """converter -> load_data_dir must reproduce compile_obj's device dict
    bit for bit (the reference's generated-code-loads-data/ contract,
    converter.cpp:664-680)."""
    import jax
    from rodent_tpu.render.compiler import compile_obj, load_data_dir
    from rodent_tpu.tools.converter import write_scene_data

    data = tmp_path / "data"
    write_scene_data(CORNELL_OBJ, str(data), arity=8,
                     max_path_len=7)
    direct = compile_obj(CORNELL_OBJ, arity=8, max_path_len=7)
    loaded = load_data_dir(str(data))
    assert loaded.num_lights == direct.num_lights
    assert loaded.materials == direct.materials
    assert loaded.device["max_path_len"] == 7

    flat_a = jax.tree.leaves(direct.device)
    flat_b = jax.tree.leaves(loaded.device)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # treedefs match too (same keys, same static BvhMeta)
    assert (jax.tree.structure(direct.device)
            == jax.tree.structure(loaded.device))


def test_load_data_dir_textured(tmp_path):
    """Texture images travel with the data dir and reload identically."""
    import jax
    from test_textured_render import make_textured_scene
    from rodent_tpu.render.compiler import compile_obj, load_data_dir
    from rodent_tpu.tools.converter import write_scene_data

    path = make_textured_scene(tmp_path)
    data = tmp_path / "data"
    write_scene_data(path, str(data))
    direct = compile_obj(path)
    loaded = load_data_dir(str(data))
    assert loaded.tex_files == direct.tex_files == ["checker.png"]
    for a, b in zip(jax.tree.leaves(direct.device),
                    jax.tree.leaves(loaded.device)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_benchmark_sweep_smoke(capsys):
    """The multi-config sweep (benchmarks/benchmark.py role) prints one
    `scene : dist : variant : N Mrays` line per config."""
    from rodent_tpu.tools import benchmark
    benchmark.main(["--scenes", "hall", "--dists", "primary,ao",
                    "--variants", "tiled", "--rays", "1024",
                    "--sizes", "hall=2000", "--iters", "1", "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2
    assert out[0].startswith("hall : primary : tiled : ")
    assert "Mrays" in out[0] and "intersections" in out[1]
