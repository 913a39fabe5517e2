"""Multi-device sharded rendering tests on the 8-virtual-device CPU mesh:
the sharded render must reproduce the single-device render exactly (same
RNG seeds per (sample, pixel), so results are bit-identical)."""
import numpy as np
import pytest
import jax

from rodent_tpu.parallel import make_mesh, render_iteration_sharded
from rodent_tpu.parallel.accounting import hlo_cross_device_collectives
from rodent_tpu.render.camera import Camera
from rodent_tpu.render.compiler import compile_obj
from rodent_tpu.render import film as film_mod
from rodent_tpu.render.integrator import render_iteration
from rodent_tpu.utils.testscenes import CORNELL_OBJ

W, H = 32, 32


@pytest.fixture(scope="module")
def cornell():
    return compile_obj(CORNELL_OBJ, max_path_len=4)


@pytest.fixture(scope="module")
def single_device_film(cornell):
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    film = film_mod.new_film(W, H)
    return np.asarray(render_iteration(cornell.device, cam, film,
                                       W, H, 4, 0))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_sp,n_px", [(1, 8), (2, 4), (4, 2)])
def test_sharded_matches_single(cornell, single_device_film, n_sp, n_px):
    mesh = make_mesh(n_px=n_px, n_sp=n_sp)
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    film = film_mod.new_film(W, H)
    out = render_iteration_sharded(cornell.device, cam, film, W, H, 4, 0,
                                   mesh)
    np.testing.assert_allclose(np.asarray(out), single_device_film,
                               rtol=1e-5, atol=1e-5)


def test_sharded_uneven_pixels(cornell):
    """W*H not divisible by the px axis: the padded strips must not
    change the image (round-3 fix; previously asserted)."""
    w, h = 31, 9  # 279 pixels, 279 % 8 != 0
    mesh = make_mesh(n_px=8, n_sp=1)
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, w, h)
    single = np.asarray(render_iteration(
        cornell.device, cam, film_mod.new_film(w, h), w, h, 2, 0))
    out = render_iteration_sharded(cornell.device, cam,
                                   film_mod.new_film(w, h), w, h, 2, 0,
                                   mesh)
    assert out.shape == single.shape
    np.testing.assert_allclose(np.asarray(out), single, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_sp,n_px", [(1, 8), (2, 4)])
def test_persistent_sharded_matches_single(cornell, n_sp, n_px):
    """The sharded persistent-wavefront iteration is bit-identical to the
    single-device persistent film (strip-local pools, disjoint sample
    ranges, psum over sp)."""
    from rodent_tpu.parallel import render_iteration_persistent_sharded
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    single = np.asarray(render_iteration_persistent(
        cornell.device, cam, film_mod.new_film(W, H), W, H, 4, 0))
    mesh = make_mesh(n_px=n_px, n_sp=n_sp)
    out = render_iteration_persistent_sharded(
        cornell.device, cam, film_mod.new_film(W, H), W, H, 4, 0, mesh)
    np.testing.assert_allclose(np.asarray(out), single, rtol=1e-5,
                               atol=1e-5)


def test_traverse_sharded_uneven_rays(cornell):
    """Ray counts that don't divide the device count are padded with dead
    rays and sliced back."""
    from rodent_tpu.parallel.mesh import traverse_sharded
    from rodent_tpu.traversal.api import make_rays
    from rodent_tpu.traversal.tiled import traverse_tiled
    r = np.random.RandomState(5)
    n = 1021  # prime, not divisible by 8
    org = np.tile(np.asarray([[0, 1, 2.7]], np.float32), (n, 1))
    d = r.randn(n, 3).astype(np.float32)
    rays = make_rays(org, d, np.zeros(n, np.float32),
                     np.full(n, 1e30, np.float32))
    single = traverse_tiled(cornell.device["bvh"], rays)
    sharded = traverse_sharded(cornell.device["bvh"], rays)
    assert sharded["t"].shape == (n,)
    np.testing.assert_array_equal(np.asarray(single["prim_id"]),
                                  np.asarray(sharded["prim_id"]))


def test_traverse_sharded_matches_single(cornell):
    """Ray-sharded traversal over 8 devices must reproduce single-device
    hits exactly (scene replicated, rays split, no collectives)."""
    import jax.numpy as jnp
    from rodent_tpu.parallel.mesh import traverse_sharded
    from rodent_tpu.traversal.api import make_rays
    from rodent_tpu.traversal.tiled import traverse_tiled
    r = np.random.RandomState(3)
    n = 1024
    org = np.tile(np.asarray([[0, 1, 2.7]], np.float32), (n, 1))
    d = r.randn(n, 3).astype(np.float32)
    rays = make_rays(org, d, np.zeros(n, np.float32),
                     np.full(n, 1e30, np.float32))
    single = traverse_tiled(cornell.device["bvh"], rays)
    sharded = traverse_sharded(cornell.device["bvh"], rays)
    np.testing.assert_array_equal(np.asarray(single["t"]),
                                  np.asarray(sharded["t"]))
    np.testing.assert_array_equal(np.asarray(single["prim_id"]),
                                  np.asarray(sharded["prim_id"]))


def test_shard_accounting_and_collective_volume(cornell):
    """Per-shard step counts, padding waste, and collective bytes for
    the sharded renderer — measured/asserted on the virtual mesh. (a) measured per-strip wavefront step counts stay
    balanced on the cornell image (the psum barriers once per iteration,
    so max/mean is the real slowdown factor); (b) padded-strip waste is
    bounded by (n_px - 1)/total; (c) the compiled sharded step contains
    exactly the expected all-reduce: one (local, 3) f32 psum over "sp"
    when n_sp > 1 and none when n_sp == 1."""
    from rodent_tpu.parallel.accounting import (measure_shard_steps,
                                                shard_plan)
    from rodent_tpu.render.camera import Camera as Cam
    W, H, spp = 50, 34, 2
    cam = Cam.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)

    plan8 = shard_plan(W, H, spp, n_px=8)
    assert plan8["padded_pixels"] < 8
    assert plan8["collective_bytes_per_device"] == 0   # no sp axis
    plan42 = shard_plan(W, H, spp, n_px=4, n_sp=2)
    # ring all-reduce of the (425, 3) f32 local film over 2 sp ranks
    assert plan42["collective_bytes_per_device"] == 425 * 3 * 4

    steps = measure_shard_steps(cornell.device, cam, W, H, spp,
                                n_px=8, pool=512)
    assert steps.shape == (1, 8)
    assert steps.max() <= steps.mean() * 1.5   # balanced strips

    # (c) HLO-level collective check on the actual sharded program
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rodent_tpu.parallel.mesh import make_mesh, shard_scene
    from rodent_tpu.render.integrator import render_iteration_persistent

    for n_sp, expect_ar in ((1, 0), (2, 1)):
        mesh = make_mesh(n_px=4, n_sp=n_sp)
        local = plan42["pixels_local"]
        total_pad = local * 4
        film = jnp.zeros((total_pad, 3), jnp.float32)
        film = jax.device_put(film, NamedSharding(mesh, P("px")))
        scene = shard_scene(cornell.device, mesh)

        @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("px")),
                 out_specs=P("px"), check_vma=False)
        def step(scene_local, film_local):
            px = jax.lax.axis_index("px")
            sp = jax.lax.axis_index("sp")
            delta = render_iteration_persistent(
                scene_local, cam, jnp.zeros_like(film_local), W, H,
                spp // n_sp, 0, pool=512, pixel_lo=px * local,
                n_pixels=local, sample_lo=sp * (spp // n_sp),
                spp_weight=1.0 / spp)
            return film_local + jax.lax.psum(delta, "sp")

        txt = jax.jit(step).lower(scene, film).compile().as_text()
        # robust to both replica_groups syntaxes (brace and iota forms);
        # a degenerate psum over a 1-member axis may survive as an
        # all-reduce with singleton groups — zero cross-device traffic
        cross = hlo_cross_device_collectives(txt)
        if expect_ar == 0:
            assert not cross, (
                f"cross-device collective at n_sp=1: {cross[0][:160]}")
        else:
            assert cross, "psum over sp missing from the HLO"
            # the psum'd operand is the (local, 3) partial film
            assert any(f"f32[{local},3]" in ln for ln in cross)


@pytest.mark.parametrize("engine,kwargs", [
    ("tiled", {}),
    ("tiled", {"compact": 2}),
    ("dense", {}),
    ("walk-interpret", {}),
])
def test_traverse_sharded_engines(cornell, engine, kwargs):
    """Every traversal engine composed with shard_map reproduces the
    single-device hits exactly; the walk kernel runs in the Pallas
    interpreter under the 8-device CPU mesh, the same sharding structure
    (replicated BVH argument, ray split, no collectives) as on GPUs."""
    from rodent_tpu.parallel.mesh import traverse_sharded
    from rodent_tpu.traversal.api import make_rays
    from rodent_tpu.traversal.tiled import traverse_tiled
    r = np.random.RandomState(11)
    n = 8 * 37 + 3  # uneven: exercises dead-ray padding through the kernel
    org = np.tile(np.asarray([[0, 1, 2.7]], np.float32), (n, 1))
    d = r.randn(n, 3).astype(np.float32)
    rays = make_rays(org, d, np.zeros(n, np.float32),
                     np.full(n, 1e30, np.float32))
    single = traverse_tiled(cornell.device["bvh"], rays)
    sharded = traverse_sharded(cornell.device["bvh"], rays,
                               engine=engine, **kwargs)
    assert sharded["t"].shape == (n,)
    np.testing.assert_array_equal(np.asarray(single["prim_id"]),
                                  np.asarray(sharded["prim_id"]))
    np.testing.assert_allclose(np.asarray(single["t"]),
                               np.asarray(sharded["t"]), rtol=1e-6)


def test_persistent_sharded_walk_matches_single(cornell):
    """The GPU renderer config (persistent pool + walk kernel, here in
    the interpreter) under the mesh matches its single-device film."""
    from rodent_tpu.parallel import render_iteration_persistent_sharded
    from rodent_tpu.render.integrator import render_iteration_persistent
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, W, H)
    single = np.asarray(render_iteration_persistent(
        cornell.device, cam, film_mod.new_film(W, H), W, H, 4, 0,
        pool=512, engine="walk-interpret"))
    mesh = make_mesh(n_px=4, n_sp=2)
    out = render_iteration_persistent_sharded(
        cornell.device, cam, film_mod.new_film(W, H), W, H, 4, 0, mesh,
        pool=512, engine="walk-interpret")
    np.testing.assert_allclose(np.asarray(out), single, rtol=1e-5,
                               atol=1e-5)


def test_hlo_collective_parser_both_syntaxes():
    """hlo_cross_device_collectives must read both replica_groups forms
    XLA emits (brace and iota) and flag only >1-member groups."""
    brace_single = ('  %ar = f32[10,3] all-reduce(%x), '
                    'replica_groups={{0},{1},{2},{3}}, to_apply=%add')
    brace_cross = ('  %ar = f32[10,3] all-reduce(%x), '
                   'replica_groups={{0,2},{1,3}}, to_apply=%add')
    iota_single = ('  %ar = f32[10,3] all-reduce(%x), '
                   'replica_groups=[4,1]<=[4], to_apply=%add')
    iota_cross = ('  %ar = f32[10,3] all-reduce(%x), '
                  'replica_groups=[2,2]<=[4], to_apply=%add')
    other = '  %g = f32[10,3] all-gather(%x), replica_groups={{0,1}}'
    txt = "\n".join([brace_single, brace_cross, iota_single, iota_cross,
                     other])
    cross = hlo_cross_device_collectives(txt)
    assert cross == [brace_cross, iota_cross]
    # ADVICE r4 medium: '{}' (all replicas, one group) is REAL traffic,
    # and a multi-member group anywhere in the list must flag, not just
    # in the first group
    empty = ('  %ar = f32[10,3] all-reduce(%x), replica_groups={}, '
             'to_apply=%add')
    later = ('  %ar = f32[10,3] all-reduce(%x), '
             'replica_groups={{0},{1,2}}, to_apply=%add')
    assert hlo_cross_device_collectives(empty) == [empty]
    assert hlo_cross_device_collectives(later) == [later]
