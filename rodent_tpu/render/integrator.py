"""Wavefront path tracer (tile-layout).

The reference processes paths breadth-first as a resident ray stream:
generate -> traverse -> sort-by-shader -> shade -> compact -> shadow-trace
-> accumulate (cpu_trace, src/render/mapping_cpu.impala:352-473;
gpu_streaming_trace, src/render/mapping_gpu.impala:308-369). Its shading
callbacks implement next-event estimation with MIS against BSDF sampling,
specular skips, and clamped Russian roulette
(make_path_tracing_renderer, src/render/renderer.impala:62-163).

Device mapping: one fixed-capacity megabatch of rays advances through a
jax.lax.while_loop over bounces; sort/compaction become masks (dead rays
have empty traversal stacks and cost nothing inside the traversal loop),
and the persistent variant regenerates dead slots with fresh samples (the
megakernel work-counter trick, mapping_gpu.impala:371-474). All per-ray
state lives in (R, 128) component layout (core.vmath); vectors are
(x, y, z) tuples — exactly the reference's SoA ray streams
(driver.impala:24-61) in tile form.

The estimator matches renderer.impala term for term:
- camera emitter seeds RNG with FNV(sample, iter, x, y) and jitters the
  pixel (:26-40);
- on_hit: emissive surfaces accumulate contrib * intensity * mis_weight
  where mis_weight = 1/(1 + state.mis * t^2 / cos * pdf_lightpick *
  emit.pdf_area) (:110-121);
- on_shadow: uniform light pick, geometry term, MIS vs bsdf pdf for area
  lights, shadow ray over [eps, 1-eps] of the unnormalized direction
  (:76-108);
- on_bounce: russian roulette clamped at 0.75, contrib *= color * cos /
  (pdf * rr), mis = specular ? 0 : 1/pdf (:123-152).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import vmath as vm
from ..core.rng import randf, seed_camera_rays
from ..core.tiles import (SELECT_CHAIN_ROWS, gather_cols,
                          gather_cols_select, num_tiles, tile)
from ..traversal.engine import components_fn
from ..traversal.sorting import ray_sort_keys
from . import bsdf as bsdf_mod
from . import light as light_mod

OFFSET = 1e-3  # shadow/bounce epsilon (renderer.impala:64)
FLT_MAX = jnp.float32(3.402823466e38)


# common.impala:82-85 semantics, componentwise (bit-identical to the
# hand-rolled bitcast form: FLT_MAX's sign bit is 0, so OR == XOR)
from ..core.math import safe_rcp as _safe_rcp  # noqa: E402


def make_rays_c(org, dirv, tmin, tmax):
    """Component-layout ray bundle with precomputed inverses
    (intersection.impala make_ray)."""
    inv_d = tuple(_safe_rcp(d) for d in dirv)
    inv_o = tuple(-o * i for o, i in zip(org, inv_d))
    return {"org": org, "dir": dirv, "inv_dir": inv_d, "inv_org": inv_o,
            "tmin": tmin, "tmax": tmax}


def _traverse(scene, rays, any_hit=False, engine="tiled", sort=False,
              compact=0, sub=0):
    """Traces a component-layout ray bundle through the named engine
    (traversal.engine: "tiled", "dense", "walk", "walk-interpret").
    compact and sub tune the tiled engine only: staged row compaction
    (pays when rays are cone-sorted so rows die together) and sequential
    sub-batches.

    sort=True re-sorts the wavefront before traversal (org9|oct|dir20
    key, dead rays to the tail) and scatters hits back to slot order —
    the reference re-sorts its stream every bounce
    (mapping_cpu.impala:35-91, mapping_gpu.impala:166-221)."""
    fn = components_fn(engine, compact=compact, sub=sub)
    if sort and "scene_lo" in scene:
        shape = rays["tmin"].shape
        flat3 = tuple(x.reshape(-1) for x in rays["org"])
        dir3 = tuple(x.reshape(-1) for x in rays["dir"])
        tmax = rays["tmax"].reshape(-1)
        keys = ray_sort_keys(flat3, dir3, scene["scene_lo"],
                             scene["scene_hi"])
        # dead rays (tmax < 0) sort to the tail so whole tail tiles
        # deactivate in the kernel (any-hit done-ray path)
        keys = jnp.where(tmax > 0.0, keys, jnp.uint32(0xFFFFFFFF))
        perm = jnp.argsort(keys)

        def g(x):
            return x.reshape(-1)[perm].reshape(shape)

        srt = make_rays_c(tuple(g(x) for x in rays["org"]),
                          tuple(g(x) for x in rays["dir"]),
                          g(rays["tmin"]), g(rays["tmax"]))
        hit = fn(scene["bvh"], srt["org"], srt["dir"],
                 srt["inv_dir"], srt["inv_org"],
                 srt["tmin"], srt["tmax"], any_hit=any_hit)

        def unsort(x):
            return (jnp.zeros(x.size, x.dtype).at[perm]
                    .set(x.reshape(-1)).reshape(shape))

        return {k: unsort(v) for k, v in hit.items()}
    return fn(scene["bvh"], rays["org"], rays["dir"],
              rays["inv_dir"], rays["inv_org"],
              rays["tmin"], rays["tmax"], any_hit=any_hit)


def surface_element(scene, rays, hit):
    """make_tri_mesh_geometry's surface element
    (src/render/geometry.impala:21-54) in component layout.

    Uses the pre-joined per-triangle shading row [mat, fn.xyz, light_id,
    n0.xyz, n1.xyz, n2.xyz, uv0, uv1, uv2] (scene compiler "tri_shade")
    so the whole fetch is ONE flat gather; scenes too large for the
    joined table (see compiler._build_device) take the memory-lean
    4-gather path (tri row + 3 vertex rows), with identical values."""
    prim = jnp.maximum(hit["prim_id"], 0)

    def bc(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    u, v = hit["u"], hit["v"]
    w = 1.0 - u - v
    if "tri_shade" in scene:
        tbl = scene["tri_shade"]
        # cornell-class scenes: a select chain replaces the per-step
        # full-pool row gather entirely (bit-identical values)
        ts = (gather_cols_select(tbl, prim)
              if tbl.shape[0] <= SELECT_CHAIN_ROWS
              else gather_cols(tbl, prim))           # (20, R, 128)
        mat_id = bc(ts[0])
        face_n = (ts[1], ts[2], ts[3])
        light_id = bc(ts[4])
        n0, n1, n2 = (ts[5], ts[6], ts[7]), (ts[8], ts[9], ts[10]), \
            (ts[11], ts[12], ts[13])
        normal = vm.normalize(vm.lerp2(n0, n1, n2, u, v))
        uv = (w * ts[14] + u * ts[16] + v * ts[18],
              w * ts[15] + u * ts[17] + v * ts[19])
    else:
        tg = gather_cols(scene["tri_geo"], prim)     # (8, R, 128)
        i0, i1, i2, mat_id = bc(tg[0]), bc(tg[1]), bc(tg[2]), bc(tg[3])
        face_n = (tg[4], tg[5], tg[6])
        light_id = bc(tg[7])
        vg0 = gather_cols(scene["vtx_geo"], i0)      # (5, R, 128)
        vg1 = gather_cols(scene["vtx_geo"], i1)
        vg2 = gather_cols(scene["vtx_geo"], i2)
        normal = vm.normalize(vm.lerp2((vg0[0], vg0[1], vg0[2]),
                                       (vg1[0], vg1[1], vg1[2]),
                                       (vg2[0], vg2[1], vg2[2]), u, v))
        uv = (w * vg0[3] + u * vg1[3] + v * vg2[3],
              w * vg0[4] + u * vg1[4] + v * vg2[4])

    is_entering = vm.dot(rays["dir"], face_n) <= 0.0
    point = vm.add(rays["org"], vm.scale(rays["dir"], hit["t"]))
    face_normal = vm.where(is_entering, face_n, vm.neg(face_n))
    shade_n = vm.where(vm.dot(rays["dir"], normal) <= 0.0,
                       normal, vm.neg(normal))
    t_, b_, n_ = vm.onb(shade_n)
    return {
        "is_entering": is_entering,
        "point": point,
        "face_normal": face_normal,
        "t": t_, "b": b_, "n": n_,
        "uv": uv,
        "prim": prim,
        "mat_id": mat_id,
        "light_id": light_id,
    }


_SELECT_CHAIN_MAX = SELECT_CHAIN_ROWS  # one tuned threshold (core.tiles)


def gather_material(scene, mat_id):
    """Per-ray material parameters from the static table — the converter's
    per-material shader closures (converter.cpp:859-927) as data. Small
    tables use select chains (zero gathers, fully fused)."""
    mt = scene["mat_table"]
    n = mt["ns"].shape[0]

    def col(key):
        c = mt[key]
        if n <= _SELECT_CHAIN_MAX:
            if c.ndim == 1:
                out = jnp.zeros(mat_id.shape, c.dtype) + c[0]
                for i in range(1, n):
                    out = jnp.where(mat_id == i, c[i], out)
                return out
            zero = jnp.zeros(mat_id.shape, c.dtype)
            out = (zero + c[0, 0], zero + c[0, 1], zero + c[0, 2])
            for i in range(1, n):
                out = vm.where(mat_id == i, (c[i, 0], c[i, 1], c[i, 2]),
                               out)
            return out
        if c.ndim == 1:
            return c[mat_id.reshape(-1)].reshape(mat_id.shape)
        g = gather_cols(c, mat_id)
        return (g[0], g[1], g[2])

    return {k: col(k) for k in ("kind", "kd", "ks", "ns", "ni", "tf",
                                "mix_k", "emissive", "kd_tex", "ks_tex")}


def _sample_bank(scene, tex_id, uv):
    """Per-ray texture-bank lookup, bilinear + repeat border
    (render.texture semantics) in component layout."""
    bank = scene["textures"]
    hw = scene["tex_hw"]
    T, HM, WM, _ = bank.shape
    flat = bank.reshape(T * HM * WM, 3)
    tid = jnp.maximum(tex_id, 0)
    h = hw[:, 0][tid.reshape(-1)].reshape(tid.shape).astype(jnp.float32)
    w = hw[:, 1][tid.reshape(-1)].reshape(tid.shape).astype(jnp.float32)
    u = uv[0] - jnp.floor(uv[0])
    v = uv[1] - jnp.floor(uv[1])
    x = u * w
    y = v * h
    # reference corner convention (image.impala:65-84): x0=trunc, kx=frac
    x0i = jnp.minimum(x.astype(jnp.int32), w.astype(jnp.int32) - 1)
    y0i = jnp.minimum(y.astype(jnp.int32), h.astype(jnp.int32) - 1)
    fx = x - jnp.floor(x)
    fy = y - jnp.floor(y)
    x1i = jnp.minimum(x0i + 1, w.astype(jnp.int32) - 1)
    y1i = jnp.minimum(y0i + 1, h.astype(jnp.int32) - 1)

    def fetch(xi, yi):
        idx = tid * (HM * WM) + yi * WM + xi
        g = gather_cols(flat, idx)
        return (g[0], g[1], g[2])

    c00 = fetch(x0i, y0i)
    c01 = fetch(x1i, y0i)
    c10 = fetch(x0i, y1i)
    c11 = fetch(x1i, y1i)
    top = vm.lerp(c00, c01, fx)
    bot = vm.lerp(c10, c11, fx)
    return vm.lerp(top, bot, fy)


def _splat(film, pixel, color, mask):
    """Scatter-add a Vec3 into the (N, 3) film; masked-off/padded rays
    write to an OOB index and get dropped."""
    r = pixel.shape[0]
    idx = jnp.where(mask, pixel, film.shape[0]).reshape(r * 128)
    rows = jnp.stack([c.reshape(r * 128) for c in color], axis=-1)
    return film.at[idx].add(rows, mode="drop")


def _splat_planar(planes, pixel, color, mask):
    """_splat against a component-planar film (3 x (N,) arrays): three 1D
    scatter-adds instead of one (B, 3) row scatter. Sums per component
    are in the same index order, so films stay bit-identical to the row
    form."""
    r = pixel.shape[0]
    idx = jnp.where(mask, pixel, planes[0].shape[0]).reshape(r * 128)
    return tuple(p.at[idx].add(c.reshape(r * 128), mode="drop")
                 for p, c in zip(planes, color))


def _shade(scene, rays, hit, state, engine="tiled", sort=False,
           compact=0, sub=0):
    """One shading stage: on_hit accumulation, NEE shadow rays, bounce
    sampling. Radiance accumulates into the per-slot register state["acc"]
    and is splatted to the film only when the path retires (one
    scatter-add per path instead of one per bounce). Returns
    (next_rays, next_state)."""
    alive = state["alive"] & (hit["prim_id"] >= 0)
    surf = surface_element(scene, rays, hit)
    mat = gather_material(scene, surf["mat_id"])
    if "textures" in scene:
        # textured kd/ks override constants (converter.cpp:877-895)
        kd_t = _sample_bank(scene, mat["kd_tex"], surf["uv"])
        ks_t = _sample_bank(scene, mat["ks_tex"], surf["uv"])
        mat["kd"] = vm.where(mat["kd_tex"] >= 0, kd_t, mat["kd"])
        mat["ks"] = vm.where(mat["ks_tex"] >= 0, ks_t, mat["ks"])
    rnd = state["rnd"]
    out_dir = vm.neg(rays["dir"])
    num_lights = scene["num_lights"]
    pdf_lightpick = 1.0 / num_lights

    # ---- on_hit: emissive surface seen by the path ----
    emit = light_mod.emission(scene["lights"], surf["light_id"], out_dir)
    if "ke_tex" in scene["lights"] and "textures" in scene:
        # textured emission (converter.cpp:794-806 has_map_ke intent):
        # radiance = Ke texture at the hit point's uv
        ket = emit["ke_tex"]
        tex_rgb = _sample_bank(scene, ket, surf["uv"])
        emit["intensity"] = vm.where((ket >= 0) & emit["valid"], tex_rgb,
                                     emit["intensity"])
    cos_o = vm.dot(out_dir, surf["n"])
    next_mis = state["mis"] * hit["t"] * hit["t"] / jnp.where(
        cos_o != 0.0, cos_o, 1.0)
    mis_w = 1.0 / (1.0 + next_mis * pdf_lightpick * emit["pdf_area"])
    hit_light = alive & mat["emissive"] & surf["is_entering"]
    emit_color = vm.scale(vm.mul(state["contrib"], emit["intensity"]),
                          mis_w)
    zero3 = vm.splat((0.0, 0.0, 0.0), like=mis_w)
    acc = vm.add(state["acc"], vm.where(hit_light, emit_color, zero3))

    # ---- on_shadow: next-event estimation (skipped for specular) ----
    do_nee = alive & ~bsdf_mod.is_specular(mat)
    lidx, rnd = light_mod.pick_uniform(num_lights, rnd)
    ls, rnd = light_mod.sample_direct(scene["lights"], lidx, rnd,
                                      surf["point"])
    if "ke_tex" in scene["lights"] and "textures" in scene:
        ket = ls["ke_tex"]
        tex_rgb = _sample_bank(scene, ket, ls["uv"])
        ls["intensity"] = vm.where((ket >= 0) & ls["valid"], tex_rgb,
                                   ls["intensity"])
    light_vec = vm.sub(ls["pos"], surf["point"])
    vis = vm.dot(light_vec, surf["n"])
    nee_ok = do_nee & (vis > 0.0) & (ls["cos"] > 0.0)
    inv_d = 1.0 / jnp.maximum(vm.length(light_vec), 1e-30)
    inv_d2 = inv_d * inv_d
    in_dir = vm.scale(light_vec, inv_d)
    pdf_e_c, pdf_e = bsdf_mod.eval_pdf(mat, surf, in_dir, out_dir,
                                       kinds=scene.get("mat_kinds"))
    pdf_e = jnp.where(ls["has_area"], pdf_e, 0.0)
    pdf_l = ls["pdf_area"] * pdf_lightpick
    inv_pdf_l = 1.0 / pdf_l
    cos_e = vis * inv_d
    cos_l = ls["cos"]
    mis = jnp.where(ls["has_area"],
                    1.0 / (1.0 + pdf_e * cos_l * inv_d2 * inv_pdf_l), 1.0)
    geom = cos_e * cos_l * inv_d2 * inv_pdf_l
    shadow_color = vm.scale(
        vm.mul(vm.mul(ls["intensity"], state["contrib"]), pdf_e_c),
        geom * mis)

    off = jnp.full_like(vis, OFFSET)
    shadow_rays = make_rays_c(surf["point"], light_vec, off,
                              jnp.where(nee_ok, 1.0 - OFFSET, -1.0))
    shadow_hit = _traverse(scene, shadow_rays, any_hit=True,
                           engine=engine, sort=sort, compact=compact,
                           sub=sub)
    add_shadow = nee_ok & (shadow_hit["prim_id"] < 0)
    acc = vm.add(acc, vm.where(add_shadow, shadow_color, zero3))

    # ---- on_bounce: russian roulette + BSDF sampling ----
    rr = jnp.minimum(2.0 * vm.luminance(state["contrib"]), 0.75)
    u_rr, rnd = randf(rnd)
    continue_ = alive & (state["depth"] < scene["max_path_len"]) & (u_rr < rr)
    new_dir, pdf, cos, color, rnd = bsdf_mod.sample(
        mat, surf, rnd, out_dir, kinds=scene.get("mat_kinds"))
    spec = bsdf_mod.is_specular(mat)
    contrib = vm.scale(vm.mul(state["contrib"], color),
                       cos / jnp.maximum(pdf * rr, 1e-30))
    new_mis = jnp.where(spec, 0.0, 1.0 / jnp.maximum(pdf, 1e-30))

    next_rays = make_rays_c(surf["point"], new_dir, off,
                            jnp.where(continue_, FLT_MAX, -1.0))
    next_state = {
        "rnd": rnd,
        "contrib": vm.where(continue_, contrib, zero3),
        "mis": new_mis,
        "depth": state["depth"] + 1,
        "pixel": state["pixel"],
        "alive": continue_,
        "acc": acc,
    }
    return next_rays, next_state


def _emit_camera(camera, width, height, sample, iteration, pix):
    """make_camera_emitter (renderer.impala:26-40) in components. pix is
    an (R, 128) array; sample may be a scalar or (R, 128)."""
    x = (pix % width).astype(jnp.uint32)
    y = (pix // width).astype(jnp.uint32)
    rnd = seed_camera_rays(jnp.asarray(sample, jnp.uint32),
                           jnp.uint32(iteration), x, y)
    jx, rnd = randf(rnd)
    jy, rnd = randf(rnd)
    kx = 2.0 * (x.astype(jnp.float32) + jx) / width - 1.0
    ky = 1.0 - 2.0 * (y.astype(jnp.float32) + jy) / height
    right = vm.splat(camera.right, like=kx)
    up = vm.splat(camera.up, like=kx)
    d = vm.splat(camera.dir, like=kx)
    raydir = vm.normalize(vm.add(vm.add(vm.scale(right, camera.w * kx),
                                        vm.scale(up, camera.h * ky)), d))
    org = vm.splat(camera.eye, like=kx)
    return org, raydir, rnd


def render_sample(scene, camera, film, width, height, sample, iteration,
                  pixel_ids=None, engine="tiled", sort=False):
    """Traces one sample per pixel to completion (one wavefront pass).
    pixel_ids indexes the *global* image; when film is a local shard of
    the same length, scatters use local indices (parallel.mesh). engine
    names the traversal engine of every trace (traversal.engine)."""
    # "pool" (stateful pool reorder) only exists in the persistent loop;
    # here it degrades to the per-call re-sort
    sort = sort in (True, "pool")
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    n = pixel_ids.shape[0]
    r = num_tiles(n)
    live = tile(jnp.ones(n, jnp.int32), r) == 1  # padding slots dead
    pix = tile(pixel_ids, r)
    film_index = (pix if film.shape[0] != n
                  else tile(jnp.arange(n, dtype=jnp.int32), r))

    org, d, rnd = _emit_camera(camera, width, height, sample, iteration,
                               pix)
    rays = make_rays_c(org, d, jnp.zeros((r, 128), jnp.float32),
                       jnp.where(live, FLT_MAX, -1.0))
    ones = jnp.ones((r, 128), jnp.float32)
    zeros = jnp.zeros((r, 128), jnp.float32)
    state = {
        "rnd": rnd,
        "contrib": (ones, ones, ones),
        "mis": zeros,
        "depth": jnp.zeros((r, 128), jnp.int32),
        "pixel": film_index,
        "alive": live,
        "acc": (zeros, zeros, zeros),
    }

    def cond(c):
        return jnp.any(c["state"]["alive"])

    def body(c):
        rays, state = c["rays"], c["state"]
        hit = _traverse(scene, rays, engine=engine, sort=sort)
        rays, state = _shade(scene, rays, hit, state, engine=engine,
                             sort=sort)
        return {"rays": rays, "state": state}

    out = jax.lax.while_loop(cond, body, {"rays": rays, "state": state})
    acc = out["state"]["acc"]
    if film.shape[0] == n and n == r * 128:
        # identity slot->pixel map: plain elementwise add, no scatter
        rows = jnp.stack([c.reshape(n) for c in acc], axis=-1)
        return film + rows
    return _splat(film, film_index, acc, live)


@partial(jax.jit, static_argnames=("camera", "width", "height", "engine"),
         donate_argnames=("film",))
def render_debug(scene, camera, film, width, height, iteration,
                 engine="tiled"):
    """Eye-light debug renderer (make_debug_renderer,
    renderer.impala:42-60): one camera pass, no NEE/bounces, accumulates
    white * -dot(ray.dir, shading normal). spp is fixed at 1 as in the
    reference (device.trace(scene, path_tracer, 1))."""
    n = width * height
    r = num_tiles(n)
    live = tile(jnp.ones(n, jnp.int32), r) == 1
    pix = tile(jnp.arange(n, dtype=jnp.int32), r)
    org, d, _rnd = _emit_camera(camera, width, height, 0, iteration, pix)
    rays = make_rays_c(org, d, jnp.zeros((r, 128), jnp.float32),
                       jnp.where(live, FLT_MAX, -1.0))
    hit = _traverse(scene, rays, engine=engine)
    surf = surface_element(scene, rays, hit)
    shade = jnp.maximum(-vm.dot(rays["dir"], surf["n"]), 0.0)
    shade = jnp.where(live & (hit["prim_id"] >= 0), shade, 0.0)
    color = (shade, shade, shade)
    if film.shape[0] == n and n == r * 128:
        rows = jnp.stack([c.reshape(n) for c in color], axis=-1)
        return film + rows
    return _splat(film, pix, color, live)


@partial(jax.jit, static_argnames=("camera", "width", "height", "spp",
                                   "engine", "sort"),
         donate_argnames=("film",))
def render_iteration(scene, camera, film, width, height, spp, iteration,
                     engine="tiled", sort=False):
    """One progressive iteration: spp wavefront passes accumulated into the
    film, weighted 1/spp so the film holds per-iteration means and the
    tonemapper divides by the iteration count alone, exactly like the
    reference (accumulate, mapping_cpu.impala:365-370; save_image,
    driver.cpp:145-162)."""
    def body(s, acc):
        return render_sample(scene, camera, acc, width, height, s,
                             iteration, engine=engine, sort=sort)
    delta = jax.lax.fori_loop(0, spp, body, jnp.zeros_like(film))
    return film + delta * (1.0 / spp)


@partial(jax.jit, static_argnames=("camera", "width", "height", "spp",
                                   "pool", "engine", "n_pixels", "sort",
                                   "compact", "sub", "retire_every",
                                   "return_steps"),
         donate_argnames=("film",))
def render_iteration_persistent(scene, camera, film, width, height, spp,
                                iteration, pool=None, engine="tiled",
                                pixel_lo=0, n_pixels=None, sample_lo=0,
                                spp_weight=None, sort=False, compact=0,
                                sub=0, retire_every=1, return_steps=False):
    """Persistent-wavefront iteration: the reference's megakernel
    regeneration trick (gpu_mega_kernel_trace,
    src/render/mapping_gpu.impala:371-474 — dead paths immediately pull
    the next sample id from a work counter so lanes never idle).

    A fixed pool of ray slots processes all width*height*spp samples of
    the iteration; when a path terminates, its slot re-emits a camera ray
    for the next unprocessed sample. RNG seeds depend only on
    (sample, iter, x, y) (renderer.impala:27-33), so the film is
    bit-identical to render_iteration's.

    engine names the traversal engine of the bounce and the NEE shadow
    traces (traversal.engine; compiler.select_render_policy picks it
    with the rest of the policy).

    Sharding hooks (parallel.mesh render_iteration_persistent_sharded):
    pixel_lo/n_pixels restrict the pass to a contiguous pixel strip
    [pixel_lo, pixel_lo + n_pixels) of the global image (pixel_lo may be
    traced, e.g. an axis_index expression); sample_lo offsets the
    per-pixel sample ids (sample-parallel axis); spp_weight overrides the
    film accumulation weight (1/spp_total instead of 1/spp_local). When
    film has n_pixels rows (a local shard), splats use strip-local
    indices.

    retire_every=K > 1 batches retirement: the film splat + sample
    regeneration (3 full-pool scatter-adds, a cumsum, a camera emission
    and ~20 state merges) runs every K-th step instead of every step;
    dead slots idle up to K-1 steps in between (a retirement also fires
    whenever NO slot is alive, so progress is guaranteed). Films are
    bit-identical for any K: samples are keyed by id, not by which slot
    or step serves them. Trade: ~1/K of the retirement cost against a
    utilization loss of roughly death_rate * (K-1)/2.

    sort="pool" reorders the POOL ITSELF at each retirement (org9|oct|
    dir20 keys of the post-regen rays, dead slots to the tail) instead
    of re-sorting + hit-unsorting around every traversal call
    (sort=True): one argsort + ~20 array permutations per retirement
    replaces two argsorts + 11 permutes + 5 hit scatters per step, and
    BOTH the bounce and the NEE shadow traversals then see coherent
    tiles. Slot identity carries the sample, so films are bit-identical
    to sort=False/True.

    sub=k routes the tiled engine's traversals through k sequential
    sub-batches (traverse_components sub_batches): each chunk pays its
    own lockstep max-trips.
    """
    n_pixels = n_pixels or width * height
    total = n_pixels * spp
    weight = spp_weight if spp_weight is not None else (1.0 / spp)
    local_film = film.shape[0] == n_pixels
    # films are bit-identical across pool sizes (RNG seeds depend only on
    # sample/iter/pixel); the pool trades per-step width for step count
    pool = pool or min(total, 1 << 15)
    r = num_tiles(pool)

    def emit_rays(sample_id):
        pix = pixel_lo + jnp.minimum(sample_id // spp, n_pixels - 1)
        s = sample_lo + sample_id % spp
        org, d, rnd = _emit_camera(camera, width, height, s, iteration,
                                   pix)
        return org, d, rnd, pix

    # arange over all r*128 slots so the padding slots (when pool is not
    # a multiple of 128) hold ids >= pool and are born dead — tile()'s
    # zero padding would mark them live and trace sample 0's path as
    # pure waste every iteration
    sample_id = jnp.arange(r * 128, dtype=jnp.int32).reshape(r, 128)
    next_free = jnp.int32(pool)
    org, d, rnd, pix = emit_rays(sample_id)
    live = sample_id < jnp.minimum(total, pool)
    rays = make_rays_c(org, d, jnp.zeros((r, 128), jnp.float32),
                       jnp.where(live, FLT_MAX, -1.0))
    ones = jnp.ones((r, 128), jnp.float32)
    zeros = jnp.zeros((r, 128), jnp.float32)
    state = {
        "rnd": rnd,
        "contrib": (ones, ones, ones),
        "mis": zeros,
        "depth": jnp.zeros((r, 128), jnp.int32),
        "pixel": pix,
        "alive": live,
        "acc": (zeros, zeros, zeros),
    }

    # pool-sort mode needs a carried real-slot mask: the padding slots
    # move when the pool is permuted, so the positional mask is wrong
    pool_sort = sort == "pool" and "scene_lo" in scene
    real0 = tile(jnp.ones(pool, jnp.int32), r) == 1
    # per-traversal-call re-sort only for sort=True (pool mode sorts once
    # per retirement instead)
    call_sort = sort is True

    def cond(c):
        # next_free < total matters only under deferred retirement (all
        # slots can be dead while samples remain unassigned); with
        # retire_every=1 it is always False when no slot is alive
        return jnp.any(c["state"]["alive"]) | (c["next_free"] < total)

    def retire(op):
        """Splat finished paths and regenerate their slots with the next
        unprocessed samples (weighted 1/spp: the film holds
        per-iteration means, mapping_cpu.impala:365-370)."""
        rays, state, film, next_free, real = op
        # dead *real* slots pull the next unprocessed sample
        dead = ~state["alive"] & real
        fidx = state["pixel"] - pixel_lo if local_film else state["pixel"]
        film = _splat_planar(film, fidx, vm.scale(state["acc"], weight),
                             dead)
        zerov = vm.splat((0.0, 0.0, 0.0), like=state["mis"])
        state = dict(state, acc=vm.where(dead, zerov, state["acc"]))
        flat_dead = dead.reshape(-1)
        order = (jnp.cumsum(flat_dead.astype(jnp.int32)) - 1).reshape(
            dead.shape)
        new_id = next_free + order
        can = dead & (new_id < total)
        next_free = jnp.minimum(
            next_free + jnp.sum(flat_dead.astype(jnp.int32)),
            jnp.int32(total))

        norg, nd, nrnd, npix = emit_rays(jnp.where(can, new_id, 0))
        fresh = make_rays_c(norg, nd, jnp.zeros_like(state["mis"]),
                            jnp.full_like(state["mis"], FLT_MAX))
        rays = {
            k: (vm.where(can, fresh[k], rays[k])
                if isinstance(rays[k], tuple)
                else jnp.where(can, fresh[k], rays[k]))
            for k in rays
        }
        ones3 = vm.splat((1.0, 1.0, 1.0), like=state["mis"])
        state = {
            "rnd": jnp.where(can, nrnd, state["rnd"]),
            "contrib": vm.where(can, ones3, state["contrib"]),
            "mis": jnp.where(can, 0.0, state["mis"]),
            "depth": jnp.where(can, 0, state["depth"]),
            "pixel": jnp.where(can, npix, state["pixel"]),
            "alive": state["alive"] | can,
            "acc": state["acc"],  # zeroed above for retired slots
        }

        if pool_sort:
            # reorder the pool by the post-regen rays' cone keys so the
            # next steps' bounce AND shadow traversals see coherent
            # tiles; dead/padding slots key to the tail so tail tiles
            # deactivate whole. Slot identity carries (pixel, acc,
            # sample), so the film is unchanged.
            shape = state["mis"].shape
            keys = ray_sort_keys(
                tuple(x.reshape(-1) for x in rays["org"]),
                tuple(x.reshape(-1) for x in rays["dir"]),
                scene["scene_lo"], scene["scene_hi"])
            keys = jnp.where(state["alive"].reshape(-1), keys,
                             jnp.uint32(0xFFFFFFFF))
            perm = jnp.argsort(keys)

            def g(x):
                return x.reshape(-1)[perm].reshape(shape)

            def gt(t):
                return tuple(g(x) for x in t)

            rays = make_rays_c(gt(rays["org"]), gt(rays["dir"]),
                               g(rays["tmin"]), g(rays["tmax"]))
            state = {
                "rnd": g(state["rnd"]),
                "contrib": gt(state["contrib"]),
                "mis": g(state["mis"]),
                "depth": g(state["depth"]),
                "pixel": g(state["pixel"]),
                "alive": g(state["alive"]),
                "acc": gt(state["acc"]),
            }
            real = g(real)
        return rays, state, film, next_free, real

    def body(c):
        rays, state, film = c["rays"], c["state"], c["film"]
        next_free = c["next_free"]
        hit = _traverse(scene, rays, engine=engine, sort=call_sort,
                        compact=compact, sub=sub)
        rays, state = _shade(scene, rays, hit, state, engine=engine,
                             sort=call_sort, compact=compact, sub=sub)

        step = c["step"]
        if retire_every == 1:
            if return_steps:
                step = step + 1
            rays, state, film, next_free, real = retire(
                (rays, state, film, next_free, c["real"]))
        else:
            # deferred retirement: fire every K-th step, or whenever no
            # slot is alive (else the loop could spin with work pending)
            step = step + 1
            do = ((step % retire_every == 0)
                  | ~jnp.any(state["alive"]))
            rays, state, film, next_free, real = jax.lax.cond(
                do, retire, lambda op: op,
                (rays, state, film, next_free, c["real"]))
        return {"rays": rays, "state": state, "film": film,
                "next_free": next_free, "step": step, "real": real}

    # the loop carries the film as 3 component planes (see _splat_planar);
    # split/recombine once per iteration, not per step
    planes = tuple(film[:, i] for i in range(3))
    out = jax.lax.while_loop(cond, body, {
        "rays": rays, "state": state, "film": planes,
        "next_free": next_free, "step": jnp.int32(0), "real": real0})
    # slots that ran out of samples never hit the dead-splat in body
    fstate = out["state"]
    fidx = fstate["pixel"] - pixel_lo if local_film else fstate["pixel"]
    planes = _splat_planar(out["film"], fidx,
                           vm.scale(fstate["acc"], weight), out["real"])
    film = jnp.stack(planes, axis=-1)
    if return_steps:
        # wavefront step count of this iteration (multi-chip accounting:
        # per-shard step counts measure load balance — parallel.accounting)
        return film, out["step"]
    return film
