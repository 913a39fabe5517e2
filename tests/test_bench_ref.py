"""Independent-engine cross-checks (bench_embree/bench_aila role,
SURVEY.md §2.3): native/ref_bvh.cpp is a self-contained single-ray BVH2
that shares no code with the production engines. These tests pin it
against the brute-force oracle and the production traversal, so it can
serve as the second, independent measurement behind every throughput
claim (tools/bench_ref CLI)."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from rodent_tpu.accel import build_bvh
from rodent_tpu.native import available
from rodent_tpu.utils.testscenes import CORNELL_OBJ
from rodent_tpu.traversal.api import (bvh_to_device, intersect_bruteforce,
                                      make_rays, traverse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not available(),
                                reason="native library unavailable")


def _soup(n, seed=0):
    r = np.random.RandomState(seed)
    base = r.randn(n, 3).astype(np.float32) * 2.0
    verts = np.concatenate(
        [base, base + r.randn(n, 3).astype(np.float32) * 0.5,
         base + r.randn(n, 3).astype(np.float32) * 0.5]).astype(np.float32)
    idx4 = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                     np.zeros(n, np.int64)], 1).astype(np.int32)
    return verts, idx4


def _rays(n, seed=1):
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def test_ref_tracer_matches_bruteforce_oracle():
    from rodent_tpu.native import RefTracer
    verts, idx4 = _soup(300)
    org, d = _rays(400)
    tr = RefTracer(verts, idx4)
    t, pid, secs = tr.traverse(org, d, 0.0, 1e9)
    assert secs > 0

    bvh = build_bvh(verts, idx4.reshape(-1), arity=4, packet=4)
    dev = bvh_to_device(bvh)
    rays = make_rays(jnp.asarray(org), jnp.asarray(d),
                     jnp.zeros(len(org), jnp.float32),
                     jnp.full(len(org), 1e9, jnp.float32))
    oracle = intersect_bruteforce(dev, rays)
    opid = np.asarray(oracle["prim_id"])
    ot = np.asarray(oracle["t"])
    assert np.array_equal(pid >= 0, opid >= 0)
    both = pid >= 0
    assert np.array_equal(pid[both], opid[both])
    np.testing.assert_allclose(t[both], ot[both], rtol=2e-5, atol=2e-5)


def test_ref_tracer_matches_production_traversal_any_hit():
    from rodent_tpu.native import RefTracer
    verts, idx4 = _soup(250, seed=3)
    org, d = _rays(300, seed=4)
    tr = RefTracer(verts, idx4)
    _, pid, _ = tr.traverse(org, d, 1e-3, 5.0, any_hit=True)

    bvh = build_bvh(verts, idx4.reshape(-1), arity=8, packet=8)
    dev = bvh_to_device(bvh)
    rays = make_rays(jnp.asarray(org), jnp.asarray(d),
                     jnp.full(len(org), 1e-3, jnp.float32),
                     jnp.full(len(org), 5.0, jnp.float32))
    hit = traverse(dev, rays, any_hit=True)
    # any-hit may land on different prims; the occlusion BIT must agree
    assert np.array_equal(pid >= 0, np.asarray(hit["prim_id"]) >= 0)


def test_bench_ref_cli_output_shape(tmp_path):
    from rodent_tpu.io import formats
    org = np.tile(np.asarray([[0, 1, 2.7]], np.float32), (64, 1))
    d = np.zeros((64, 3), np.float32)
    d[:, 2] = -1.0
    d[:, 0] = np.linspace(-0.3, 0.3, 64)
    formats.write_rays(str(tmp_path / "c.rays"), org, d)
    out = subprocess.run(
        [sys.executable, "-m", "rodent_tpu.tools.bench_ref",
         "-obj", CORNELL_OBJ,
         "-ray", str(tmp_path / "c.rays"), "--bench", "2",
         "-o", str(tmp_path / "c.fbuf")],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    # bench_embree.cpp:407-413 output shape
    assert lines[0].endswith("iteration(s)")
    assert lines[1].endswith("Mrays/sec")
    assert lines[-1].endswith("intersection(s)")
    assert int(lines[-1].split()[0]) > 0  # camera rays into the box hit
    from rodent_tpu.io import formats
    assert len(formats.read_fbuf(str(tmp_path / "c.fbuf"))) == 64


def test_bench_ref_ao_implies_any_hit(tmp_path):
    """--dist ao must measure any-hit occlusion by default (the benchmark
    rows it anchors always do); --closest restores closest-hit. The fbuf in
    any-hit mode holds 0/1 occlusion flags, in closest mode hit
    distances."""
    common = [sys.executable, "-m", "rodent_tpu.tools.bench_ref",
              "--scene", "hall", "--tris", "2000", "--dist", "ao",
              "--width", "16", "--height", "16", "--bench", "1"]
    env = {"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"}
    from rodent_tpu.io import formats
    out = subprocess.run(common + ["-o", str(tmp_path / "a.fbuf")],
                         capture_output=True, text=True, cwd=ROOT,
                         env=env)
    assert out.returncode == 0, out.stderr
    vals = formats.read_fbuf(str(tmp_path / "a.fbuf"))
    assert set(np.unique(vals)) <= {0.0, 1.0}  # occlusion flags
    out2 = subprocess.run(common + ["--closest",
                                    "-o", str(tmp_path / "c.fbuf")],
                          capture_output=True, text=True,
                          cwd=ROOT, env=env)
    assert out2.returncode == 0, out2.stderr
    vals2 = formats.read_fbuf(str(tmp_path / "c.fbuf"))
    hit = vals > 0.5
    assert hit.any()
    assert not set(np.unique(vals2[hit])) <= {0.0, 1.0}  # distances
