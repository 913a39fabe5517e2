"""BVH build + traversal tests: the batched XLA traversal must agree with
the brute-force all-triangles oracle (the reference's Embree-device role,
SURVEY.md §4) on closest-hit distance for random and structured scenes."""
import numpy as np
import pytest

from rodent_tpu.accel import build_bvh, WideBvh
from rodent_tpu.io import formats, obj
from rodent_tpu.traversal.api import (bvh_to_device, intersect_bruteforce,
                                      make_rays, occluded, traverse)
from rodent_tpu.utils.testscenes import CORNELL_OBJ


def random_tri_soup(n, seed=0):
    r = np.random.RandomState(seed)
    base = r.randn(n, 3).astype(np.float32) * 2.0
    v0 = base
    v1 = base + r.randn(n, 3).astype(np.float32) * 0.5
    v2 = base + r.randn(n, 3).astype(np.float32) * 0.5
    verts = np.concatenate([v0, v1, v2]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                    r.randint(0, 5, n)], axis=1).astype(np.int32)
    return verts, idx.reshape(-1)


def random_rays(n, seed=1, tmin=0.0, tmax=1e30):
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    return make_rays(org, d, np.full(n, tmin, np.float32),
                     np.full(n, tmax, np.float32))


def check_match(bvh, rays, atol=1e-3):
    dev = bvh_to_device(bvh)
    got = traverse(dev, rays)
    want = intersect_bruteforce(dev, rays)
    got_t = np.asarray(got["t"])
    want_t = np.asarray(want["t"])
    np.testing.assert_allclose(got_t, want_t, atol=atol, rtol=1e-4)
    # same hit/miss classification
    np.testing.assert_array_equal(np.asarray(got["prim_id"]) >= 0,
                                  np.asarray(want["prim_id"]) >= 0)
    return got, want


def test_bvh_invariants_random():
    verts, idx = random_tri_soup(300)
    bvh = build_bvh(verts, idx, arity=8)
    assert bvh.arity == 8
    # every original tri appears at least once among valid lanes (SBVH
    # spatial splits may duplicate references, bvh.h:497-539)
    pid = bvh.prim_id.reshape(-1)
    valid = pid != -1
    real = pid[valid] & 0x7FFFFFFF
    assert set(real.tolist()) == set(range(300))
    # child encoding: inner refs in range, leaf refs in range
    ch = bvh.child.reshape(-1)
    inner = ch[ch > 0]
    leaf = ch[ch < 0]
    assert (inner - 1 < bvh.num_nodes).all()
    assert ((~leaf) < bvh.num_packets).all()
    # empty slots have inverted (inf) bounds
    empty = bvh.child == 0
    assert (bvh.bounds[:, 0, :][empty] == np.inf).all()


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_traversal_matches_bruteforce_random(arity):
    verts, idx = random_tri_soup(257, seed=3)
    bvh = build_bvh(verts, idx, arity=arity, packet=4)
    rays = random_rays(512, seed=7)
    check_match(bvh, rays)


def test_traversal_cornell_primary():
    mesh, _, _ = obj.load_scene_mesh(CORNELL_OBJ)
    bvh = build_bvh(mesh.vertices, mesh.indices, arity=8)
    # primary rays from the reference camera (--eye 0 1 2.7 --dir 0 0 -1)
    W = H = 32
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = 1 - (np.arange(H) + 0.5) / H * 2
    kx, ky = np.meshgrid(xs, ys)
    w = np.tan(np.radians(60.0) / 2)
    d = np.stack([kx * w, ky * w, -np.ones_like(kx)], axis=-1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org = np.tile(np.asarray([[0.0, 1.0, 2.7]], np.float32), (W * H, 1))
    rays = make_rays(org, d.astype(np.float32),
                     np.zeros(W * H, np.float32),
                     np.full(W * H, 1e30, np.float32))
    got, want = check_match(bvh, rays)
    # everything should hit inside the box
    assert (np.asarray(got["prim_id"]) >= 0).all()
    # geom ids = material ids, in range
    g = np.asarray(got["geom_id"])
    assert g.min() >= 1 and g.max() <= 8


def test_tmin_tmax_respected():
    verts, idx = random_tri_soup(64, seed=5)
    bvh = build_bvh(verts, idx)
    dev = bvh_to_device(bvh)
    rays_near = random_rays(128, seed=9, tmin=0.0, tmax=0.5)
    got = traverse(dev, rays_near)
    t = np.asarray(got["t"])
    hit = np.asarray(got["prim_id"]) >= 0
    assert (t[hit] <= 0.5).all()
    # miss t stays at tmax
    np.testing.assert_allclose(t[~hit], 0.5, atol=0)


def test_occluded_agrees_with_closest():
    verts, idx = random_tri_soup(200, seed=11)
    bvh = build_bvh(verts, idx)
    dev = bvh_to_device(bvh)
    rays = random_rays(256, seed=13, tmax=2.0)
    blocked = np.asarray(occluded(dev, rays))
    closest = np.asarray(traverse(dev, rays)["prim_id"]) >= 0
    np.testing.assert_array_equal(blocked, closest)


def test_bvh_survives_file_roundtrip(tmp_path):
    verts, idx = random_tri_soup(100, seed=17)
    bvh = build_bvh(verts, idx, arity=8)
    p = tmp_path / "s.bvh"
    formats.write_bvh(p, bvh.to_block())
    back = WideBvh.from_block(formats.read_bvh(p, formats.BVH8_TRI4))
    rays = random_rays(128, seed=19)
    a = traverse(bvh_to_device(bvh), rays)
    b = traverse(bvh_to_device(back), rays)
    np.testing.assert_array_equal(np.asarray(a["t"]), np.asarray(b["t"]))
    np.testing.assert_array_equal(np.asarray(a["prim_id"]),
                                  np.asarray(b["prim_id"]))


def test_single_triangle_uv():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([0, 1, 2, 0], np.int32)
    bvh = build_bvh(verts, idx)
    dev = bvh_to_device(bvh)
    org = np.asarray([[0.25, 0.25, 1.0], [0.6, 0.3, -2.0], [2.0, 2.0, 1.0]],
                     np.float32)
    d = np.asarray([[0, 0, -1], [0, 0, 1], [0, 0, -1]], np.float32)
    rays = make_rays(org, d, np.zeros(3, np.float32),
                     np.full(3, 1e30, np.float32))
    hit = traverse(dev, rays)
    t = np.asarray(hit["t"])
    np.testing.assert_allclose(t[:2], [1.0, 2.0], atol=1e-6)
    assert np.asarray(hit["prim_id"])[2] == -1
    # barycentric convention: u along v0->v1, v along v0->v2
    np.testing.assert_allclose(np.asarray(hit["u"])[0], 0.25, atol=1e-6)
    np.testing.assert_allclose(np.asarray(hit["v"])[0], 0.25, atol=1e-6)
    np.testing.assert_allclose(np.asarray(hit["u"])[1], 0.6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(hit["v"])[1], 0.3, atol=1e-5)


def test_tiled_matches_api():
    """The tile-layout production traversal must agree exactly with the
    reference-layout api.traverse on hits and distances."""
    from rodent_tpu.traversal.tiled import occluded_tiled, traverse_tiled
    verts, idx = random_tri_soup(257, seed=23)
    bvh = build_bvh(verts, idx, arity=8)
    dev = bvh_to_device(bvh)
    # 300 rays: not a multiple of 128, exercises tile padding
    rays = random_rays(300, seed=29)
    a = traverse(dev, rays)
    b = traverse_tiled(dev, rays)
    np.testing.assert_array_equal(np.asarray(a["t"]), np.asarray(b["t"]))
    np.testing.assert_array_equal(np.asarray(a["prim_id"]),
                                  np.asarray(b["prim_id"]))
    np.testing.assert_array_equal(np.asarray(a["geom_id"]),
                                  np.asarray(b["geom_id"]))
    np.testing.assert_array_equal(np.asarray(a["u"]), np.asarray(b["u"]))
    rays2 = random_rays(256, seed=31, tmax=2.0)
    blocked_a = np.asarray(occluded(dev, rays2))
    blocked_b = np.asarray(occluded_tiled(dev, rays2))
    np.testing.assert_array_equal(blocked_a, blocked_b)


def test_dense_matches_api():
    """The dense small-scene engine (traversal.dense: brute-force every
    Tri packet, no BVH walk) must agree with api.traverse: identical
    prim/geom ids (same closest hit on tie-free scenes) and t/u/v equal
    to float ULPs (XLA contracts the mul+add chains into FMAs
    differently between the two program shapes). Covers dead slots
    (tmax < tmin), tile padding (ray count not a multiple of 128), and
    any-hit occlusion."""
    from rodent_tpu.traversal.dense import traverse_dense
    verts, idx = random_tri_soup(100, seed=61)   # 13 Tri8 packets
    bvh = build_bvh(verts, idx, arity=8, packet=8)
    dev = bvh_to_device(bvh)
    rays = random_rays(300, seed=67)             # exercises padding
    rays["tmax"] = rays["tmax"].at[::5].set(-1.0)  # dead slots
    a = traverse(dev, rays)
    b = traverse_dense(dev, rays)
    for k in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-5, atol=1e-6)
    rays2 = random_rays(256, seed=71, tmax=2.0)
    blocked_a = np.asarray(occluded(dev, rays2))
    blocked_b = np.asarray(
        traverse_dense(dev, rays2, any_hit=True)["prim_id"]) >= 0
    np.testing.assert_array_equal(blocked_a, blocked_b)


def test_tiled_staged_compaction_matches():
    """compact_stages > 0 (staged-halving row compaction with hit
    scatter-back) must be exactly equal to the single-stage loop: the
    cascade only re-partitions which while_loop iteration serves a ray,
    never the traversal math."""
    from rodent_tpu.traversal.tiled import traverse_tiled
    verts, idx = random_tri_soup(300, seed=47)
    bvh = build_bvh(verts, idx, arity=8)
    dev = bvh_to_device(bvh)
    # 1500 rays -> 12 rows: several halvings incl. a non-power-of-two
    # tail row; mixed live/dead from the start (some tmax < tmin)
    rays = random_rays(1500, seed=53)
    rays["tmax"] = rays["tmax"].at[::7].set(-1.0)
    for any_hit in (False, True):
        base = traverse_tiled(dev, rays, any_hit=any_hit)
        got = traverse_tiled(dev, rays, any_hit=any_hit, compact_stages=6)
        if any_hit:
            np.testing.assert_array_equal(
                np.asarray(base["prim_id"]) >= 0,
                np.asarray(got["prim_id"]) >= 0)
        else:
            for k in ("t", "u", "v", "prim_id", "geom_id"):
                np.testing.assert_array_equal(np.asarray(base[k]),
                                              np.asarray(got[k]))


def test_octant_sort_preserves_results():
    from rodent_tpu.traversal.sorting import sort_rays
    verts, idx = random_tri_soup(200, seed=41)
    bvh = build_bvh(verts, idx)
    dev = bvh_to_device(bvh)
    rays = random_rays(512, seed=43)
    base = traverse(dev, rays)
    lo = verts.min(0)
    hi = verts.max(0)
    sorted_rays, perm = sort_rays(rays, lo, hi)
    inv = np.argsort(np.asarray(perm))
    got = traverse(dev, sorted_rays)
    np.testing.assert_array_equal(np.asarray(got["t"])[inv],
                                  np.asarray(base["t"]))
    np.testing.assert_array_equal(np.asarray(got["prim_id"])[inv],
                                  np.asarray(base["prim_id"]))
    # sorted keys are non-decreasing, and octants group contiguously
    # WITHIN each coarse origin cell (org9-major key: cell, then octant,
    # then direction cone)
    from rodent_tpu.traversal.sorting import ray_octant, ray_sort_keys
    keys = np.asarray(ray_sort_keys(sorted_rays["org"],
                                    sorted_rays["dir"], lo, hi))
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    cells = keys >> 23
    octs = np.asarray(ray_octant(sorted_rays["dir"]))
    same_cell = np.diff(cells) == 0
    assert (np.diff(octs)[same_cell] >= 0).all()


def test_tiled_waterfall_hooks_preserve_results():
    """The waterfall diagnostics (fixed_iters schedule pinning and the
    result-preserving ablations) must not change hits: 'leafalways' and
    'nosort' are semantically neutral; fixed_iters >= the free-running
    trip count drains completely."""
    from rodent_tpu.traversal.tiled import traverse_tiled
    verts, idx = random_tri_soup(257, seed=47)
    bvh = build_bvh(verts, idx, arity=8)
    dev = bvh_to_device(bvh)
    rays = random_rays(300, seed=49)
    a = traverse(dev, rays)
    cnt = traverse_tiled(dev, rays, debug_counters=True)
    trips = int(cnt["counters"]["iters"])
    # leafalways drains at least as fast as the gated loop, so pinning
    # the schedule past the free-running trip count still drains fully;
    # nosort changes the pop ORDER (more trips possible) so it runs free
    for kw in (dict(ablate=("leafalways",), fixed_iters=trips + 8,
                    debug_counters=True),
               dict(ablate=("nosort",), debug_counters=True)):
        b = traverse_tiled(dev, rays, **kw)
        np.testing.assert_allclose(np.asarray(a["t"]),
                                   np.asarray(b["t"]),
                                   atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(a["prim_id"]),
                                      np.asarray(b["prim_id"]))
    # sequential sub-batches (lockstep-tail bound at chunk granularity)
    # must be hit-exact, with and without staged compaction inside each
    # chunk; needs >= 8 rows per chunk, so a bigger batch (R = 32 rows)
    rays4k = random_rays(4096, seed=53)
    a4 = traverse(dev, rays4k)
    for kw in (dict(sub_batches=2),
               dict(sub_batches=4, compact_stages=3)):
        b = traverse_tiled(dev, rays4k, **kw)
        np.testing.assert_allclose(np.asarray(a4["t"]),
                                   np.asarray(b["t"]),
                                   atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(a4["prim_id"]),
                                      np.asarray(b["prim_id"]))


def chain_bvh(depth, arity=4):
    """Hand-built adversarial BVH: a depth-long chain where every node has
    one inner child and one single-tri leaf, and ALL boxes overlap — a ray
    down the axis pushes both children at every level, so shared-stack
    usage grows linearly with depth (~depth+1 entries). Round-1 kernels
    fixed the stack at 32/64 and silently dropped pushes here."""
    n = depth
    bounds = np.zeros((n, 6, arity), np.float32)
    bounds[:, 0::2, :] = np.inf   # mins of empty slots
    bounds[:, 1::2, :] = -np.inf  # maxs of empty slots
    child = np.zeros((n, arity), np.int32)
    for i in range(n):
        for s in range(2 if i < n - 1 else 1):
            bounds[i, :, s] = [-100, 100, -100, 100, -100, 100]
        if i < n - 1:
            child[i, 0] = i + 2        # inner ref to node i+1
            child[i, 1] = ~i           # leaf packet i
        else:
            child[i, 0] = ~i
    m = 4
    v0 = np.zeros((n, m, 3), np.float32)
    v1 = np.zeros((n, m, 3), np.float32)
    v2 = np.zeros((n, m, 3), np.float32)
    pid = np.full((n, m), -1, np.int32)
    gid = np.zeros((n, m), np.int32)
    for i in range(n):
        z = -(i + 1.0)
        v0[i, 0] = (-10, -10, z)
        v1[i, 0] = (20, -10, z)
        v2[i, 0] = (-10, 20, z)
        pid[i, 0] = i
    e1 = v0 - v1
    e2 = v2 - v0
    nrm = np.cross(e1, e2)
    return WideBvh(arity=arity, packet=m, bounds=bounds, child=child,
                   tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n=nrm,
                   prim_id=pid, geom_id=gid)


def test_stack_needs_exact_on_chain():
    from rodent_tpu.traversal.api import compute_stack_needs
    bvh = chain_bvh(60)
    shared, node = compute_stack_needs(bvh.child)
    # chain: S(i) = S(i+1) + 1 with S(last) = 1 -> 60; node-only stack
    # holds a single inner child at a time -> 1
    assert shared == 60
    assert node == 1


def test_deep_tree_no_silent_stack_overflow():
    """Adversarial deep BVH (stack need ~60 > the old fixed 32/64): all
    three traversal paths must still produce brute-force-correct hits
    because stacks are now sized from BvhMeta at trace time."""
    from rodent_tpu.traversal.engine import traverse as engine_traverse
    from rodent_tpu.traversal.tiled import traverse_tiled
    from rodent_tpu.traversal.walk import stack_depth
    bvh = chain_bvh(60)
    dev = bvh_to_device(bvh)
    assert dev["meta"].shared_stack == 60
    n_rays = 64
    r = np.random.RandomState(61)
    org = np.stack([r.uniform(-5, 5, n_rays), r.uniform(-5, 5, n_rays),
                    np.full(n_rays, 1.0)], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n_rays, 1))
    rays = make_rays(org, d, np.zeros(n_rays, np.float32),
                     np.full(n_rays, 1e30, np.float32))
    want = intersect_bruteforce(dev, rays)
    # every ray must find the NEAREST (first) triangle at t == 2.0
    np.testing.assert_allclose(np.asarray(want["t"]), 2.0, atol=1e-6)
    # the walk kernel's per-ray stack is sized from the same metadata
    assert stack_depth(dev) == 60
    for fn in (traverse, traverse_tiled,
               lambda dv, rs: engine_traverse(dv, rs, "walk-interpret")):
        got = fn(dev, rays)
        np.testing.assert_allclose(np.asarray(got["t"]),
                                   np.asarray(want["t"]), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got["prim_id"]),
                                      np.asarray(want["prim_id"]))


def test_axis_aligned_rays_negative_origin():
    """Zero direction components + negative origins: the old
    bound*inv_dir + inv_org slab form produced (inf - inf) = NaN and
    silently missed everything (safe_rcp yields +-FLT_MAX for d == 0)."""
    verts = np.asarray([[-4, -4, -1], [4, -4, -1], [-4, 4, -1]], np.float32)
    idx = np.asarray([0, 1, 2, 0], np.int32)
    bvh = build_bvh(verts, idx)
    dev = bvh_to_device(bvh)
    org = np.asarray([[-3.0, -3.0, 1.0], [-2.0, 3.9, 1.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0]] * 2, np.float32)
    rays = make_rays(org, d, np.zeros(2, np.float32),
                     np.full(2, 1e30, np.float32))
    hit = traverse(dev, rays)
    np.testing.assert_allclose(np.asarray(hit["t"])[0], 2.0, atol=1e-6)
    assert np.asarray(hit["prim_id"])[0] == 0


def test_sbvh_spatial_splits_on_skinny_diagonals():
    """Long thin diagonal triangles are the SBVH motivation (Stich et al.
    2009): spatial splits must fire (duplicated refs) and hits must stay
    brute-force-correct. Also checks the fast binned tier agrees."""
    r = np.random.RandomState(71)
    n = 400
    base = r.randn(n, 3).astype(np.float32) * 3.0
    along = r.randn(n, 3).astype(np.float32)
    along /= np.linalg.norm(along, axis=1, keepdims=True)
    v0 = base
    v1 = base + along * 8.0  # long edge
    v2 = base + r.randn(n, 3).astype(np.float32) * 0.05  # skinny
    verts = np.concatenate([v0, v1, v2]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                    np.zeros(n)], axis=1).astype(np.int32).reshape(-1)
    sb = build_bvh(verts, idx, arity=8, quality=1)
    fast = build_bvh(verts, idx, arity=8, quality=0)
    dup = int((sb.prim_id.reshape(-1) != -1).sum()) - n
    assert dup > 0, "expected spatial splits to duplicate refs"
    rays = random_rays(512, seed=73)
    check_match(sb, rays)
    a = traverse(bvh_to_device(sb), rays)
    b = traverse(bvh_to_device(fast), rays)
    np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]),
                               atol=1e-3, rtol=1e-4)


def test_coincident_degenerate_cluster_builds_and_traverses():
    """>64 coincident zero-area triangles used to drive the DP wide
    collapse into a fixed point (every subtree cost 0 -> the expansion
    returned the node itself -> infinite emit loop) in BOTH builder
    tiers. The guard forces binary expansion; hits must still match the
    brute-force oracle (degenerate tris never intersect: det == 0)."""
    verts = np.zeros((303, 3), np.float32)
    verts[300:] = [[0, 0, 0], [4, 0, 0], [0, 4, 0]]
    idx = np.concatenate(
        [np.stack([np.arange(100) * 3, np.arange(100) * 3 + 1,
                   np.arange(100) * 3 + 2, np.zeros(100, int)], 1),
         [[300, 301, 302, 0]]]).astype(np.int32).reshape(-1)
    for use_native in (True, False):
        bvh = build_bvh(verts, idx, arity=8, packet=8,
                        use_native=use_native, quality=0)
        rays = random_rays(256, seed=91)
        check_match(bvh, rays)


# ---- the per-ray walk kernel (traversal/walk.py), interpret mode ----


def traverse_walk(dev, rays, any_hit=False, interpret=True):
    """Row-layout rays through the walk kernel (traversal.engine)."""
    from rodent_tpu.traversal.engine import traverse as engine_traverse
    return engine_traverse(dev, rays,
                           "walk-interpret" if interpret else "walk",
                           any_hit=any_hit)


def _assert_same_hits(got, want, exact=True):
    for k in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    for k in ("t", "u", "v"):
        if exact:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_walk_matches_api(arity):
    """Same visit order, comparator network and update rules as
    api.traverse: closest hits agree bit for bit, any-hit occlusion
    agrees, at every arity."""
    verts, idx = random_tri_soup(257, seed=3)
    dev = bvh_to_device(build_bvh(verts, idx, arity=arity, packet=4))
    rays = random_rays(300, seed=7)         # not a multiple of 32
    _assert_same_hits(traverse_walk(dev, rays, interpret=True),
                      traverse(dev, rays))
    rays2 = random_rays(256, seed=9, tmax=2.0)
    np.testing.assert_array_equal(
        np.asarray(traverse_walk(dev, rays2, any_hit=True,
                                 interpret=True)["prim_id"]) >= 0,
        np.asarray(occluded(dev, rays2)))


@pytest.mark.parametrize("n_rays", [1, 33, 200])
def test_walk_matches_bruteforce_ragged(n_rays):
    """Ray counts that are not multiples of the 128-ray tile pad with
    dead rays; hits agree with the all-triangles oracle."""
    verts, idx = random_tri_soup(150, seed=13)
    dev = bvh_to_device(build_bvh(verts, idx, arity=8, packet=4))
    rays = random_rays(n_rays, seed=17)
    got = traverse_walk(dev, rays, interpret=True)
    want = intersect_bruteforce(dev, rays)
    assert got["t"].shape == (n_rays,)
    np.testing.assert_allclose(np.asarray(got["t"]), np.asarray(want["t"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(got["prim_id"]) >= 0,
                                  np.asarray(want["prim_id"]) >= 0)


def test_walk_dead_rays_and_window():
    """Dead rays (tmax < tmin) stay misses with t == tmax; hits respect
    the [tmin, tmax] window."""
    verts, idx = random_tri_soup(64, seed=5)
    dev = bvh_to_device(build_bvh(verts, idx))
    rays = random_rays(96, seed=9, tmin=0.0, tmax=0.5)
    rays["tmax"] = rays["tmax"].at[::4].set(-1.0)
    got = traverse_walk(dev, rays, interpret=True)
    t = np.asarray(got["t"])
    hit = np.asarray(got["prim_id"]) >= 0
    assert not hit[::4].any()
    np.testing.assert_array_equal(t[::4], -1.0)
    assert (t[hit] <= 0.5).all()
    _assert_same_hits(got, traverse(dev, rays))


def test_walk_multi_packet_leaves():
    """Leaves spanning several Tri packets continue in place (the
    continuation entry is code - 1, never pushed)."""
    verts, idx = random_tri_soup(257, seed=47)
    bvh = build_bvh(verts, idx, arity=4, packet=4, leaf_threshold=32)
    assert (bvh.prim_id[:, -1] < 0).sum() < bvh.num_packets  # multi
    dev = bvh_to_device(bvh)
    rays = random_rays(160, seed=49)
    _assert_same_hits(traverse_walk(dev, rays, interpret=True),
                      traverse(dev, rays))


def test_walk_components_layout():
    """The (R, 128) component entry used by the renderer agrees with the
    row-layout wrapper."""
    from rodent_tpu.core.tiles import tile
    from rodent_tpu.traversal.walk import traverse_walk_components
    verts, idx = random_tri_soup(100, seed=61)
    dev = bvh_to_device(build_bvh(verts, idx, arity=8))
    rays = random_rays(256, seed=67)
    r = 2

    def comp(k):
        return tuple(tile(rays[k][:, i], r) for i in range(3))

    out = traverse_walk_components(dev, comp("org"), comp("dir"),
                                   comp("inv_dir"), comp("inv_org"),
                                   tile(rays["tmin"], r),
                                   tile(rays["tmax"], r), interpret=True)
    assert out["t"].shape == (r, 128)
    flat = {k: v.reshape(-1) for k, v in out.items()}
    _assert_same_hits(flat, traverse_walk(dev, rays, interpret=True))


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_lowers_for_gpu(any_hit):
    """The kernel lowers to Triton IR for the CUDA backend without a
    GPU present (catches primitives the Triton lowering lacks, such as
    reduce_or)."""
    import jax
    verts, idx = random_tri_soup(64, seed=5)
    dev = bvh_to_device(build_bvh(verts, idx, arity=8))
    rays = random_rays(64, seed=9)
    fn = jax.jit(lambda d, r: traverse_walk(d, r, any_hit=any_hit,
                                            interpret=False))
    text = fn.trace(dev, rays).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
def test_walk_compiled_matches_api(gpu_device):
    """Compiled for the card, the kernel still agrees with api.traverse."""
    verts, idx = random_tri_soup(257, seed=3)
    dev = bvh_to_device(build_bvh(verts, idx, arity=8, packet=4))
    rays = random_rays(300, seed=7)
    _assert_same_hits(traverse_walk(dev, rays, interpret=False),
                      traverse(dev, rays), exact=False)
