"""Core math / RNG / sampling unit tests.

The RNG tests pin down the exact 32-bit semantics of the reference's
xorshift/randf/FNV (src/core/random.impala) via independently computed
numpy uint32 models.
"""
import numpy as np
import jax.numpy as jnp

from rodent_tpu.core import math as vm
from rodent_tpu.core import rng, sampling


def np_xorshift(x):
    x = np.uint32(1) if x == 0 else np.uint32(x)
    x ^= np.uint32((int(x) << 13) & 0xFFFFFFFF)
    x ^= x >> np.uint32(17)
    x ^= np.uint32((int(x) << 5) & 0xFFFFFFFF)
    return x


def test_xorshift_matches_scalar_model():
    seeds = np.array([1, 2, 12345, 0xDEADBEEF, 0], dtype=np.uint32)
    got = np.asarray(rng.xorshift(jnp.asarray(seeds)))
    want = np.array([np_xorshift(s) for s in seeds], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_randf_range_and_bit_trick():
    state = jnp.arange(1, 10001, dtype=jnp.uint32)
    vals, new_state = rng.randf(state)
    vals = np.asarray(vals)
    assert vals.min() >= 0.0 and vals.max() < 1.0
    # mantissa trick: value == (bits/2^23) for bits = state & 0x7FFFFF
    s = np.asarray(new_state)
    np.testing.assert_allclose(vals, (s & 0x7FFFFF) / float(1 << 23), rtol=0, atol=0)


def test_fnv_hash_model():
    def np_fnv(h, d):
        h = np.uint32(h)
        for shift in (0, 8, 16, 24):
            h = np.uint32((int(h) * 16777619) & 0xFFFFFFFF) ^ np.uint32((d >> shift) & 0xFF)
        return h

    h = np_fnv(0x811C9DC5, 7)
    h = np_fnv(h, 3)
    got = rng.fnv_hash(rng.fnv_hash(rng.fnv_init(), jnp.uint32(7)), jnp.uint32(3))
    assert int(got) == int(h)


def test_seed_camera_rays_distinct():
    x = jnp.arange(64, dtype=jnp.uint32)
    seeds = rng.seed_camera_rays(jnp.uint32(0), jnp.uint32(0), x, jnp.uint32(5))
    assert len(set(np.asarray(seeds).tolist())) == 64


def test_orthonormal_basis():
    n = vm.normalize(vm.vec3(np.random.randn(100), np.random.randn(100), np.random.randn(100)))
    t, b, nn = vm.make_orthonormal_basis(n)
    np.testing.assert_allclose(np.asarray(vm.dot(t, b)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(t, nn)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(b, nn)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(t)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(b)), 1.0, atol=1e-5)


def test_reflect():
    v = vm.vec3(1.0, 1.0, 0.0)
    n = vm.vec3(0.0, 1.0, 0.0)
    r = vm.reflect(v, n)
    np.testing.assert_allclose(np.asarray(r), [-1.0, 1.0, 0.0], atol=1e-6)


def test_safe_rcp():
    x = jnp.asarray([1.0, -2.0, 0.0, 1e-12, -1e-12], dtype=jnp.float32)
    r = np.asarray(vm.safe_rcp(x))
    assert r[0] == 1.0 and r[1] == -0.5
    assert r[2] == np.float32(3.402823466e38)
    assert r[3] == np.float32(3.402823466e38)
    assert r[4] == -np.float32(3.402823466e38)


def test_prodsign():
    got = np.asarray(vm.prodsign(jnp.float32(3.0), jnp.float32(-2.0)))
    assert got == -3.0
    got = np.asarray(vm.prodsign(jnp.float32(-3.0), jnp.float32(-2.0)))
    assert got == 3.0


def test_cosine_hemisphere_stats():
    state = jnp.arange(1, 200001, dtype=jnp.uint32)
    u, state = rng.randf(state)
    v, state = rng.randf(state)
    d, pdf = sampling.sample_cosine_hemisphere(u, v)
    d = np.asarray(d)
    assert (d[:, 2] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-3)
    # E[cos] for cosine-weighted = 2/3
    np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=5e-3)


def test_cosine_power_pdf_consistency():
    u = jnp.asarray(np.random.rand(1000), jnp.float32)
    v = jnp.asarray(np.random.rand(1000), jnp.float32)
    k = jnp.float32(10.0)
    d, pdf = sampling.sample_cosine_power_hemisphere(k, u, v)
    want = sampling.cosine_power_hemisphere_pdf(np.asarray(d)[:, 2], 10.0)
    np.testing.assert_allclose(np.asarray(pdf), np.asarray(want), rtol=2e-3)


def test_sample_triangle_inside():
    v0 = vm.vec3(0.0, 0.0, 0.0)
    v1 = vm.vec3(1.0, 0.0, 0.0)
    v2 = vm.vec3(0.0, 1.0, 0.0)
    u = jnp.asarray(np.random.rand(500), jnp.float32)
    v = jnp.asarray(np.random.rand(500), jnp.float32)
    p = np.asarray(sampling.sample_triangle(u, v, v0, v1, v2))
    assert (p[:, 0] >= 0).all() and (p[:, 1] >= 0).all()
    assert (p[:, 0] + p[:, 1] <= 1.0 + 1e-6).all()


def test_russian_roulette():
    c = vm.vec3(10.0, 10.0, 10.0)
    assert float(sampling.russian_roulette(c)) == 0.75
    c = vm.vec3(0.1, 0.1, 0.1)
    np.testing.assert_allclose(float(sampling.russian_roulette(c)), 0.2, rtol=1e-5)


def test_gather_cols_select_bit_identical():
    """The small-table select-chain gather must reproduce gather_cols
    bit-for-bit — including bitcast-integer columns whose f32 bit
    patterns are denormal (the chain runs on the int32 view so no
    arithmetic can flush them)."""
    import jax
    from rodent_tpu.core.tiles import gather_cols, gather_cols_select
    r = np.random.RandomState(3)
    n, c = 20, 13
    table = r.randn(n, c).astype(np.float32)
    # column 5 carries bitcast int32 ids (denormal as f32), like
    # tri_shade's mat/light columns
    ids = r.randint(-3, 40, n).astype(np.int32)
    table[:, 5] = ids.view(np.float32)
    table = jnp.asarray(table)
    idx = jnp.asarray(r.randint(0, n, (4, 128)).astype(np.int32))
    a = np.asarray(gather_cols(table, idx))
    b = np.asarray(gather_cols_select(table, idx))
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
