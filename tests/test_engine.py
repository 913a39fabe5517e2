"""Traversal engine choice (traversal.engine): one place maps the backend
and the scene to an engine, and every engine answers like api.traverse."""
import numpy as np
import pytest

from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal.api import bvh_to_device, make_rays, traverse
from rodent_tpu.traversal.dense import DENSE_MAX_PACKETS
from rodent_tpu.traversal.engine import ENGINES, select_engine
from rodent_tpu.traversal.engine import traverse as engine_traverse


def _soup(n, seed):
    r = np.random.RandomState(seed)
    base = r.randn(n, 3).astype(np.float32) * 2.0
    verts = np.concatenate([base + r.randn(n, 3).astype(np.float32) * 0.5
                            for _ in range(3)]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                    r.randint(0, 3, n)], axis=1).astype(np.int32)
    return verts, idx.reshape(-1)


def _rays(n, seed, tmax=1e30):
    r = np.random.RandomState(seed)
    return make_rays(r.randn(n, 3).astype(np.float32) * 3.0,
                     r.randn(n, 3).astype(np.float32),
                     np.zeros(n, np.float32), np.full(n, tmax, np.float32))


@pytest.fixture(scope="module")
def small():
    v, i = _soup(40, 1)           # a few Tri8 packets: dense-sized
    return bvh_to_device(build_bvh(v, i, arity=8, packet=8))


@pytest.fixture(scope="module")
def large():
    v, i = _soup(300, 2)
    return bvh_to_device(build_bvh(v, i, arity=8, packet=4))


@pytest.mark.parametrize("platform,size,engine", [
    ("cpu", "small", "dense"),
    ("cpu", "large", "tiled"),
    ("gpu", "small", "walk"),
    ("gpu", "large", "walk"),
])
def test_select_engine_per_platform(platform, size, engine, small, large):
    dev = small if size == "small" else large
    assert (dev["tris"].shape[0] <= DENSE_MAX_PACKETS) == (size == "small")
    assert select_engine(dev, platform) == engine


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_select_engine_rejects_other_platforms(platform, small):
    with pytest.raises(ValueError):
        select_engine(small, platform)


def test_select_engine_defaults_to_backend(small):
    # the forced-CPU suite: the default backend is the CPU
    assert select_engine(small) == "dense"


@pytest.mark.parametrize("engine", ["tiled", "dense", "walk-interpret"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_engines_match_api(engine, any_hit, small):
    """Each engine's row-layout entry agrees with api.traverse: closest
    hits by id (t to float ULPs: the engines compile to different
    programs), any-hit by occlusion; 300 rays pad to whole tiles."""
    rays = _rays(300, 3, tmax=2.0 if any_hit else 1e30)
    got = engine_traverse(small, rays, engine, any_hit=any_hit)
    want = traverse(small, rays, any_hit=any_hit)
    assert got["t"].shape == (300,)
    if any_hit:
        np.testing.assert_array_equal(np.asarray(got["prim_id"]) >= 0,
                                      np.asarray(want["prim_id"]) >= 0)
    else:
        np.testing.assert_array_equal(np.asarray(got["prim_id"]),
                                      np.asarray(want["prim_id"]))
        np.testing.assert_allclose(np.asarray(got["t"]),
                                   np.asarray(want["t"]), rtol=1e-5)


def test_unknown_engine_raises(small):
    assert "packet" not in ENGINES
    with pytest.raises(ValueError):
        engine_traverse(small, _rays(8, 4), "packet")
