"""Data-driven, batched BSDF layer (component-leading layout).

The reference builds one specialized closure per material
(src/render/material.impala) and dispatches per geometry; its megakernel
mode additionally fuses all "simple" materials into one data-driven shader
(src/driver/converter.cpp:683-709). Over ray megabatches the fused form
is the native one: every ray carries its material *parameters* (selected
by geometry id) plus a small `kind` code, and eval/pdf/sample are
computed for all kinds with masks — there are only a handful of kinds,
so this is a few fused elementwise ops rather than divergent control
flow.

Layout: colors/directions are Vec3 tuples of full-tile arrays (see
core.vmath); scalars are plain arrays, so every shading op is a dense
elementwise pass over one component.

Kinds:
  0 BLACK   fully absorbing (make_black_bsdf, material.impala:75-83)
  1 DIFFUSE Lambert (make_diffuse_bsdf, :85-100)
  2 PHONG   physically-correct Phong (make_phong_bsdf, :103-123)
  3 MIRROR  perfect mirror (make_mirror_bsdf, :126-135)
  4 GLASS   Fresnel reflection/refraction (make_glass_bsdf, :138-163)
  5 MIX     lerp(diffuse, phong, k) importance-sampled
            (make_mix_bsdf, :166-192; k = lum_ks/(lum_ks+lum_kd) as in
            converter.cpp:905-911)

Conventions follow the reference exactly: out_dir points away from the
surface toward the viewer (= -ray.dir), in_dir is the light/bounce
direction; "local" is the shading-normal ONB; validity of samples is
checked against the *face* normal (make_bsdf_sample, material.impala:63-74).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..core import vmath as vm
from ..core.rng import randf
from ..core.sampling import (cosine_hemisphere_pdf,
                             cosine_power_hemisphere_pdf,
                             sample_cosine_hemisphere_c,
                             sample_cosine_power_hemisphere_c)

BLACK, DIFFUSE, PHONG, MIRROR, GLASS, MIX = 0, 1, 2, 3, 4, 5
ALL_KINDS = (BLACK, DIFFUSE, PHONG, MIRROR, GLASS, MIX)


@jax.tree_util.register_static
@dataclass(frozen=True)
class KindSet:
    """Static set of BSDF kinds present in a scene. The converter knows
    the scene's materials at compile time, so the integrator's jit can
    prune the masked dispatch to just the kinds that occur — the
    analog of the reference emitting generated code containing only the
    used materials (converter.cpp:683-709). Lives in the device dict as
    a static pytree node (like traversal.api.BvhMeta)."""
    kinds: tuple


def _want(kinds):
    if kinds is None:
        return frozenset(ALL_KINDS)
    if isinstance(kinds, KindSet):
        return frozenset(kinds.kinds)
    return frozenset(kinds)


def positive_cos(a, b):
    return jnp.maximum(vm.dot(a, b), 0.0)


def is_specular(mat):
    return (mat["kind"] == MIRROR) | (mat["kind"] == GLASS)


def _diffuse_eval(mat):
    return vm.scale(mat["kd"], 1.0 / vm.PI)


def _phong_eval_pdf(mat, surf, in_dir, out_dir):
    refl = vm.reflect(out_dir, surf["n"])
    cos = positive_cos(in_dir, refl)
    ns = mat["ns"]
    e = vm.scale(mat["ks"], jnp.power(cos, ns) * (ns + 2.0)
                 * (1.0 / (2.0 * vm.PI)))
    return e, cosine_power_hemisphere_pdf(cos, ns)


def eval_pdf(mat, surf, in_dir, out_dir, kinds=None):
    """Returns (color Vec3, pdf) of the BSDF for in/out directions.
    kinds (a KindSet / iterable / None=all) statically prunes the masked
    dispatch to the kinds present in the scene."""
    want = _want(kinds)
    kind = mat["kind"]
    cos_n = positive_cos(in_dir, surf["n"])

    need_d = DIFFUSE in want or MIX in want
    need_p = PHONG in want or MIX in want
    if need_d:
        d_e = _diffuse_eval(mat)
        d_pdf = cosine_hemisphere_pdf(cos_n)
    if need_p:
        p_e, p_pdf = _phong_eval_pdf(mat, surf, in_dir, out_dir)

    branches = []
    if DIFFUSE in want:
        branches.append((DIFFUSE, d_e, d_pdf))
    if PHONG in want:
        branches.append((PHONG, p_e, p_pdf))
    if MIX in want:
        k = mat["mix_k"]
        branches.append((MIX, vm.lerp(d_e, p_e, k),
                         d_pdf + (p_pdf - d_pdf) * k))

    if len(want) == 1 and branches:
        # every lane is this kind: no select needed
        return branches[0][1], branches[0][2]
    color = vm.splat((0.0, 0.0, 0.0), like=cos_n)
    pdf = jnp.zeros_like(cos_n)
    for kval, c_, p_ in reversed(branches):
        color = vm.where(kind == kval, c_, color)
        pdf = jnp.where(kind == kval, p_, pdf)
    return color, pdf


def _validate(surf, in_dir, pdf, color, inverted):
    """make_bsdf_sample's right-side-of-surface check
    (material.impala:63-74): invalid -> pdf 1, color black."""
    above = vm.dot(in_dir, surf["face_normal"]) > 0.0
    valid = (pdf > 0.0) & (inverted ^ above)
    zero = vm.splat((0.0, 0.0, 0.0), like=pdf)
    return jnp.where(valid, pdf, 1.0), vm.where(valid, color, zero)


def sample(mat, surf, rnd, out_dir, kinds=None):
    """Samples the present kinds with masks; a fixed 3 uniforms are drawn
    per ray so RNG state threading is batch-uniform (the per-material
    draw count of the reference only changes the noise pattern, not the
    estimator — and keeping it fixed also makes films identical across
    kind-set specializations).

    kinds (KindSet / iterable / None=all) statically prunes the lobes
    computed and the final dispatch to the kinds present in the scene.

    Returns (in_dir Vec3, pdf, cos, color Vec3, rnd)."""
    want = _want(kinds)
    kind = mat["kind"]
    n = surf["n"]
    t_, b_ = surf["t"], surf["b"]

    u0, rnd = randf(rnd)  # mix lobe selector / glass fresnel selector
    u1, rnd = randf(rnd)
    u2, rnd = randf(rnd)
    falsem = jnp.zeros_like(u0, bool)
    ones = jnp.ones_like(u0)

    need_d = DIFFUSE in want or MIX in want
    need_p = PHONG in want or MIX in want
    need_refl = need_p or MIRROR in want or GLASS in want

    if need_refl:
        refl = vm.reflect(out_dir, n)

    if need_d:
        # --- diffuse: cosine hemisphere in the shading frame ---
        d_local, d_pdf = sample_cosine_hemisphere_c(u1, u2)
        d_dir = vm.basis_mul(t_, b_, n, d_local)
        d_cos = d_local[2]
        d_color = _diffuse_eval(mat)
        d_pdf, d_color = _validate(surf, d_dir, d_pdf, d_color, falsem)

    if need_p:
        # --- phong: cosine-power lobe around the reflection direction ---
        ns = mat["ns"]
        p_local, p_pdf = sample_cosine_power_hemisphere_c(ns, u1, u2)
        rt, rb, rn = vm.onb(refl)
        p_dir = vm.basis_mul(rt, rb, rn, p_local)
        p_cos = positive_cos(p_dir, n)
        p_color = vm.scale(mat["ks"], p_pdf * (ns + 2.0) / (ns + 1.0))
        p_pdf_v, p_color = _validate(surf, p_dir, p_pdf, p_color, falsem)

    branches = []  # (kind, dir, pdf, cos, color)
    if DIFFUSE in want:
        branches.append((DIFFUSE, d_dir, d_pdf, d_cos, d_color))

    if PHONG in want:
        branches.append((PHONG, p_dir, p_pdf_v, p_cos, p_color))

    if MIRROR in want:
        m_pdf, m_color = _validate(surf, refl, ones, mat["ks"], falsem)
        branches.append((MIRROR, refl, m_pdf, ones, m_color))

    if GLASS in want:
        # --- glass (adjoint=false as in the path tracer) ---
        k_ior = jnp.where(surf["is_entering"], 1.0 / mat["ni"], mat["ni"])
        cos_i = vm.dot(out_dir, n)
        cos2_t = 1.0 - k_ior * k_ior * (1.0 - cos_i * cos_i)
        cos_t = jnp.sqrt(jnp.maximum(cos2_t, 0.0))
        f_s = (k_ior * cos_i - cos_t) / jnp.maximum(
            k_ior * cos_i + cos_t, 1e-30)
        f_p = (cos_i - k_ior * cos_t) / jnp.maximum(
            cos_i + k_ior * cos_t, 1e-30)
        fresnel = 0.5 * (f_s * f_s + f_p * f_p)
        refr_dir = vm.sub(vm.scale(n, k_ior * cos_i - cos_t),
                          vm.scale(out_dir, k_ior))
        refract = (cos2_t > 0.0) & (u0 > fresnel)
        g_dir = vm.where(refract, refr_dir, refl)
        g_color = vm.where(refract, mat["tf"], mat["ks"])
        g_pdf, g_color = _validate(surf, g_dir, ones, g_color, refract)
        branches.append((GLASS, g_dir, g_pdf, ones, g_color))

    if MIX in want:
        # --- mix(diffuse, phong, k): pick a lobe, combine pdfs/colors ---
        k = mat["mix_k"]
        pick_phong = u0 < k  # reference: randf >= k -> mat1 (diffuse)
        x_dir = vm.where(pick_phong, p_dir, d_dir)
        x_cos = jnp.where(pick_phong, p_cos, d_cos)
        de = _diffuse_eval(mat)
        dp = cosine_hemisphere_pdf(positive_cos(x_dir, n))
        pe, pp = _phong_eval_pdf(mat, surf, x_dir, out_dir)
        chosen_color = vm.where(pick_phong, p_color, d_color)
        chosen_pdf = jnp.where(pick_phong, p_pdf_v, d_pdf)
        other_color = vm.where(pick_phong, de, pe)
        other_pdf = jnp.where(pick_phong, dp, pp)
        x_color = vm.where(pick_phong,
                           vm.lerp(other_color, chosen_color, k),
                           vm.lerp(chosen_color, other_color, k))
        x_pdf = jnp.where(pick_phong,
                          other_pdf + (chosen_pdf - other_pdf) * k,
                          chosen_pdf + (other_pdf - chosen_pdf) * k)
        branches.append((MIX, x_dir, x_pdf, x_cos, x_color))

    if len(want) == 1 and branches:
        # every lane is this kind: no dispatch selects at all
        _, in_dir, pdf, cos, color = branches[0]
        return in_dir, pdf, cos, color, rnd

    # default (BLACK / absent): in_dir=out_dir, pdf=1, cos=1, color=0
    in_dir, pdf, cos = out_dir, ones, ones
    color = vm.splat((0.0, 0.0, 0.0), like=u0)
    for kval, bd, bp, bc, bcol in reversed(branches):
        m = kind == kval
        in_dir = vm.where(m, bd, in_dir)
        pdf = jnp.where(m, bp, pdf)
        cos = jnp.where(m, bc, cos)
        color = vm.where(m, bcol, color)
    return in_dir, pdf, cos, color, rnd
