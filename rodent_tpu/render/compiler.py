"""Scene compiler: OBJ/MTL -> device-ready scene (the converter analog).

The reference converter (src/driver/converter.cpp:575-967) emits Impala
source that is compiled with the renderer, baking shaders/lights/camera
into code. Here the same information is compiled into *static
data + jit-specialized config*: a material parameter table (the megakernel
"simple material fusion" generalized to all kinds), a triangle-light table,
and the BVH, all as device arrays; shader dispatch is data-driven masks
(see render.bsdf).

Reproduced converter behaviors:
- cleanup_obj (converter.cpp:467-557): dummy material for missing
  definitions (kd = (0,1,1)), dedup of identical materials, removal of
  unused ones;
- material -> BSDF mapping (converter.cpp:859-927): illum 5 = mirror,
  illum 7 = glass(1, ni, ks, tf), else diffuse/phong/mix by kd/ks,
  black when both zero; emissive when ke != 0;
- triangle-light extraction with precomputed normal/inv_area
  (converter.cpp:771-856) and light_ids buffer per triangle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import os

import numpy as np
import jax.numpy as jnp

from ..accel import build_bvh
from ..io import obj as obj_io
from ..traversal.api import bvh_to_device
from ..traversal.dense import DENSE_MAX_PACKETS
from ..traversal.engine import select_engine
from . import bsdf as bsdf_mod
from . import light as light_mod


def _luminance(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def material_to_params(mat, tex_index=None):
    """Maps an obj Material to (kind, params) per converter.cpp:859-927.
    tex_index maps texture file names to bank ids (-1 = untextured)."""
    tex_index = tex_index or {}
    ke = tuple(mat.ke)
    emissive = ke != (0.0, 0.0, 0.0) or mat.map_ke != ""
    if mat.illum == 5:
        kind = bsdf_mod.MIRROR
    elif mat.illum == 7:
        kind = bsdf_mod.GLASS
    else:
        has_diffuse = tuple(mat.kd) != (0.0, 0.0, 0.0) or mat.map_kd != ""
        has_specular = tuple(mat.ks) != (0.0, 0.0, 0.0) or mat.map_ks != ""
        if has_diffuse and has_specular:
            kind = bsdf_mod.MIX
        elif has_diffuse:
            kind = bsdf_mod.DIFFUSE
        elif has_specular:
            kind = bsdf_mod.PHONG
        else:
            kind = bsdf_mod.BLACK
    lum_ks = _luminance(mat.ks)
    lum_kd = _luminance(mat.kd)
    mix_k = lum_ks / (lum_ks + lum_kd) if (lum_ks + lum_kd) != 0.0 else 0.0
    return {
        "kind": kind,
        "kd": tuple(mat.kd),
        "ks": tuple(mat.ks),
        "ns": float(mat.ns),
        "ni": float(mat.ni),
        "tf": tuple(mat.tf),
        "mix_k": float(mix_k),
        "emissive": bool(emissive),
        "ke": ke,
        "kd_tex": tex_index.get(mat.map_kd, -1),
        "ks_tex": tex_index.get(mat.map_ks, -1),
    }


def _dummy_material():
    """cleanup_obj's dummy material (converter.cpp:469-485): cyan kd."""
    m = obj_io.Material(name="")
    m.kd = (0.0, 1.0, 1.0)
    return m


@dataclass
class CompiledScene:
    device: dict                      # arrays for the integrator
    mesh: object                      # host TriMesh
    materials: list                   # material names after cleanup
    mat_params: list = field(default_factory=list)
    num_lights: int = 0
    tex_files: list = field(default_factory=list)


def _build_device(mesh, mat_params, lights, light_ids, bvh, max_path_len,
                  num_lights, tex_images=None):
    """Assembles the integrator-facing device dict from host-side pieces.
    Shared by compile_obj (in-memory path) and load_data_dir (data/ path)
    so the two routes are bit-identical."""
    mat_table = {
        "kind": jnp.asarray([p["kind"] for p in mat_params], jnp.int32),
        "kd": jnp.asarray([p["kd"] for p in mat_params], jnp.float32),
        "ks": jnp.asarray([p["ks"] for p in mat_params], jnp.float32),
        "ns": jnp.asarray([p["ns"] for p in mat_params], jnp.float32),
        "ni": jnp.asarray([p["ni"] for p in mat_params], jnp.float32),
        "tf": jnp.asarray([p["tf"] for p in mat_params], jnp.float32),
        "mix_k": jnp.asarray([p["mix_k"] for p in mat_params], jnp.float32),
        "emissive": jnp.asarray([p["emissive"] for p in mat_params], bool),
        "kd_tex": jnp.asarray([p["kd_tex"] for p in mat_params], jnp.int32),
        "ks_tex": jnp.asarray([p["ks_tex"] for p in mat_params], jnp.int32),
    }

    # packed geometry rows for single-gather surface elements
    # (geometry.impala make_tri_mesh_geometry's data, row-fused):
    # tri row: [i0, i1, i2, mat (i32 bitcast), fn.xyz, light_id]
    idx4 = mesh.indices.reshape(-1, 4)
    tri_geo = np.zeros((len(idx4), 8), np.float32)
    tri_geo[:, 0:4] = idx4.astype(np.int32).view(np.float32)
    tri_geo[:, 4:7] = mesh.face_normals
    tri_geo[:, 7] = light_ids.astype(np.int32).view(np.float32)
    # vertex row: [n.xyz, tu, tv]
    vtx_geo = np.concatenate(
        [mesh.normals, mesh.texcoords], axis=1).astype(np.float32)

    # fully pre-joined per-TRIANGLE shading row so the integrator's
    # surface element is ONE flat gather instead of four (tri_geo by
    # prim + vtx_geo by each corner) — the 4 gathers were the largest
    # attributable item of the persistent wavefront step after the
    # planar splat (95 ms of a 344 ms cornell iteration, profiled).
    # row: [mat, fn.xyz, light_id, n0.xyz, n1.xyz, n2.xyz,
    #       uv0, uv1, uv2] = 20 cols; values identical to the 4-gather
    # path, so films are bit-identical. Memory is 80 B/tri — gated to
    # smaller scenes; huge meshes keep the memory-lean 4-gather path.
    tri_shade = None
    if len(idx4) <= 4_000_000:
        tri = idx4[:, :3]
        tri_shade = np.concatenate([
            tri_geo[:, 3:4],                     # mat (i32 bits)
            mesh.face_normals,                   # fn.xyz
            tri_geo[:, 7:8],                     # light_id (i32 bits)
            mesh.normals[tri[:, 0]],
            mesh.normals[tri[:, 1]],
            mesh.normals[tri[:, 2]],
            mesh.texcoords[tri[:, 0]],
            mesh.texcoords[tri[:, 1]],
            mesh.texcoords[tri[:, 2]],
        ], axis=1).astype(np.float32)

    device = {
        "bvh": bvh_to_device(bvh),
        # scene AABB for the per-step ray sort (sorting.ray_sort_keys
        # origin grid) — the renderer re-sorts the wavefront every bounce
        # like the reference (mapping_cpu.impala:409 sort_rays)
        "scene_lo": jnp.asarray(mesh.vertices.min(0), jnp.float32),
        "scene_hi": jnp.asarray(mesh.vertices.max(0), jnp.float32),
        "tri_geo": jnp.asarray(tri_geo),
        "vtx_geo": jnp.asarray(vtx_geo),
        "vertices": jnp.asarray(mesh.vertices),
        "normals": jnp.asarray(mesh.normals),
        "face_normals": jnp.asarray(mesh.face_normals),
        "texcoords": jnp.asarray(mesh.texcoords),
        "indices": jnp.asarray(mesh.indices.reshape(-1, 4)),
        **({"tri_shade": jnp.asarray(tri_shade)}
           if tri_shade is not None else {}),
        "mat_table": mat_table,
        "lights": {k: jnp.asarray(v) for k, v in lights.items()},
        "light_ids": jnp.asarray(light_ids),
        "num_lights": num_lights,
        "max_path_len": max_path_len,
        # static kind set: lets the integrator's jit prune the masked
        # BSDF dispatch to the kinds this scene actually uses (the
        # generated-code-only-contains-used-materials specialization,
        # converter.cpp:683-709)
        "mat_kinds": bsdf_mod.KindSet(
            tuple(sorted({int(p["kind"]) for p in mat_params}))),
    }
    if tex_images:
        from . import texture as tx
        bank, hw = tx.build_bank(tex_images)
        device["textures"] = jnp.asarray(bank)
        device["tex_hw"] = jnp.asarray(hw)
    return device


def compile_obj(path, arity=8, max_path_len=64):
    """OBJ path -> CompiledScene. The (scene, arity, max_path_len) choice
    plays the role of the converter CLI flags baked into generated code
    (converter.cpp:973-1070)."""
    f = obj_io.load_obj(path)
    mtl_lib = obj_io.load_mtl_libs(path, f)
    mtl_lib[""] = _dummy_material()

    # cleanup_obj: replace missing, dedup identical, drop unused
    names = list(f.materials)
    for i, n in enumerate(names):
        if n != "" and n not in mtl_lib:
            names[i] = ""
    remap_name = {}
    for i, n1 in enumerate(names):
        if n1 in remap_name:
            continue
        for n2 in names[i + 1:]:
            if n2 not in remap_name and n2 != n1 and _mat_eq(
                    mtl_lib[n1], mtl_lib[n2]):
                remap_name[n2] = n1
    used = set()
    for o in f.objects:
        for g in o.groups:
            for face in g.faces:
                n = names[face.material]
                used.add(remap_name.get(n, n))
    new_names = [n for n in dict.fromkeys(names) if n in used]
    id_remap = {}
    for old_id, n in enumerate(names):
        n = remap_name.get(n, n)
        # unused materials never appear on faces; map them anywhere
        id_remap[old_id] = new_names.index(n) if n in used else 0
    for o in f.objects:
        for g in o.groups:
            for face in g.faces:
                face.material = id_remap[face.material]
    mats = [mtl_lib[n] for n in new_names]

    mesh = obj_io.compute_tri_mesh(f)

    # texture bank from all referenced image files (converter.cpp images
    # map, :595-607; gamma-2.2 to linear on load like image.cpp:10-18)
    base = os.path.dirname(os.path.abspath(path))
    tex_files = []
    for m in mats:
        for name in (m.map_kd, m.map_ks, m.map_ke):
            if name and name not in tex_files:
                p_ = os.path.join(base, name)
                if os.path.exists(p_):
                    tex_files.append(name)
    tex_index = {n: i for i, n in enumerate(tex_files)}
    mat_params = [material_to_params(m, tex_index) for m in mats]

    # triangle lights from emissive materials; textured emission carries
    # the Ke texture id into the light table (converter.cpp:794-806)
    ke_table = np.asarray([p["ke"] for p in mat_params], np.float32)
    ke_tex_ids = [tex_index.get(m.map_ke, -1) for m in mats]
    emissive_tri = np.asarray(
        [mat_params[m]["emissive"] for m in mesh.tri_materials], bool)
    lights, light_ids = light_mod.build_light_table(
        mesh, ke_table, emissive_tri,
        ke_tex=ke_tex_ids if any(k >= 0 for k in ke_tex_ids) else None)
    num_lights = int((lights["kind"] == light_mod.TRIANGLE).sum()) or 1

    bvh = build_bvh(mesh.vertices, mesh.indices, arity=arity)

    tex_images = None
    if tex_files:
        from . import texture as tx
        tex_images = [tx.load_texture(os.path.join(base, n))
                      for n in tex_files]
    device = _build_device(mesh, mat_params, lights, light_ids, bvh,
                           max_path_len, num_lights, tex_images)
    return CompiledScene(device=device, mesh=mesh, materials=new_names,
                         mat_params=mat_params, num_lights=num_lights,
                         tex_files=tex_files)


_MESH_PALETTE = [
    (0.73, 0.70, 0.64), (0.62, 0.57, 0.50), (0.66, 0.24, 0.18),
    (0.25, 0.45, 0.22), (0.30, 0.33, 0.45), (0.60, 0.55, 0.35),
]


def compile_mesh(verts, indices, arity=8, max_path_len=64,
                 emitter="above", emitter_frac=0.30, emitter_power=None,
                 kds=None, bvh_kwargs=None, materials=None,
                 tex_images=None):
    """Procedural mesh -> CompiledScene (renderable benchmark scenes).

    The reference renders its benchmark scenes from full OBJ exports
    (benchmarks/bench.sh:9-85); our hall/crown/powerplant scenes exist
    as raw (vertices (V,3) f32, indices (T*4,) i32 [i0,i1,i2,mat])
    geometry (utils.testscenes), so this path supplies the remaining
    scene ingredients: per-mat-id diffuse materials from a fixed palette
    (or `kds`), smooth vertex normals, and one emissive area-light panel
    — placed just under the bbox top when emitter="inside" (enclosed
    interiors like the hall) or slightly above it when "above" (open
    scenes); emitter_frac scales the panel's xz footprint. The device
    dict is assembled by the same _build_device as compile_obj.

    materials: optional list of obj_io.Material, index = mat id in
    `indices` (overrides the palette; the emitter is still appended) —
    the full-MTL bench-scene path (reference bench scenes mix textured/
    specular/glass shaders, converter.cpp:859-927). tex_images: dict
    name -> (H, W, 3) linear f32 image backing the materials' map_kd/
    map_ks references (procedural textures; file-based textures go
    through compile_obj). Textured scenes get triplanar-projected UVs
    (dominant-normal-axis planar projection per vertex) since raw
    procedural geometry carries none."""
    verts = np.asarray(verts, np.float32)
    idx4 = np.asarray(indices, np.int32).reshape(-1, 4).copy()
    lo, hi = verts.min(0), verts.max(0)
    ext = hi - lo
    n_mats = int(idx4[:, 3].max()) + 1 if len(idx4) else 1

    # ---- emissive panel (2 tris, its own material id) ----
    cx, cz = (lo[0] + hi[0]) / 2, (lo[2] + hi[2]) / 2
    hx, hz = ext[0] * emitter_frac / 2, ext[2] * emitter_frac / 2
    y = hi[1] - 0.04 * ext[1] if emitter == "inside" \
        else hi[1] + 0.10 * ext[1]
    pv = np.asarray([[cx - hx, y, cz - hz], [cx + hx, y, cz - hz],
                     [cx + hx, y, cz + hz], [cx - hx, y, cz + hz]],
                    np.float32)
    v0 = len(verts)
    # winding: normal points down (-y) toward the scene — corners run
    # (-hx,-hz),(+hx,-hz),(+hx,+hz),(-hx,+hz), so cross(v1-v0, v2-v0)
    # of [0,1,2]/[0,2,3] is -y (the [0,2,1]/[0,3,2] winding pointed +y,
    # leaving only dim indirect light via the ceiling)
    panel = np.asarray([[v0 + 0, v0 + 1, v0 + 2, n_mats],
                        [v0 + 0, v0 + 2, v0 + 3, n_mats]], np.int32)
    verts = np.concatenate([verts, pv])
    idx4 = np.concatenate([idx4, panel])

    # ---- host mesh: smooth normals, face normals, zero uvs ----
    tri = idx4[:, :3]
    e1 = verts[tri[:, 1]] - verts[tri[:, 0]]
    e2 = verts[tri[:, 2]] - verts[tri[:, 0]]
    fn = np.cross(e1, e2)
    fl = np.linalg.norm(fn, axis=1, keepdims=True)
    fn_unit = fn / np.where(fl > 0, fl, 1)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, tri[:, k], fn)  # area-weighted (obj.cpp:474-489)
    vl = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.where(vl > 0, vn / np.where(vl > 0, vl, 1),
                  np.asarray([0, 1, 0], np.float32))
    uv = np.zeros((len(verts), 2), np.float32)
    if tex_images:
        # triplanar projection: pick the two coords orthogonal to each
        # vertex normal's dominant axis, scaled to ~4 world units per
        # tile (procedural geometry ships no UVs; this gives every
        # surface stretch-free texture coordinates)
        ax = np.argmax(np.abs(vn), axis=1)
        u_axis = np.where(ax == 0, 1, 0)
        v_axis = np.where(ax == 2, 1, 2)
        uv = np.stack([verts[np.arange(len(verts)), u_axis],
                       verts[np.arange(len(verts)), v_axis]],
                      axis=1).astype(np.float32) * 0.25
    mesh = obj_io.TriMesh(
        vertices=verts.astype(np.float32),
        normals=vn.astype(np.float32),
        face_normals=fn_unit.astype(np.float32),
        texcoords=uv,
        indices=idx4.reshape(-1).astype(np.int32))

    # ---- materials: palette diffuse (or caller MTLs) + the emitter ----
    if emitter_power is None:
        # fixed default radiance: the NEE geometry term scales with the
        # panel area (which tracks the scene bbox via emitter_frac), so a
        # constant lands all three benchmark scenes in a usable exposure
        # range; pass emitter_power explicitly to retune a scene
        emitter_power = 8.0
    mats = []
    if materials is not None:
        assert len(materials) >= n_mats, \
            f"scene uses {n_mats} material ids, got {len(materials)}"
        mats = list(materials[:n_mats])
    else:
        for i in range(n_mats):
            kd = (kds[i] if kds is not None
                  else _MESH_PALETTE[i % len(_MESH_PALETTE)])
            mats.append(obj_io.Material(name=f"m{i}", kd=tuple(kd)))
    mats.append(obj_io.Material(name="emitter",
                                ke=(emitter_power,) * 3))
    tex_files = list(tex_images) if tex_images else []
    tex_index = {n: i for i, n in enumerate(tex_files)}
    mat_params = [material_to_params(m, tex_index) for m in mats]

    ke_table = np.asarray([p["ke"] for p in mat_params], np.float32)
    emissive_tri = np.asarray(
        [mat_params[m]["emissive"] for m in mesh.tri_materials], bool)
    lights, light_ids = light_mod.build_light_table(
        mesh, ke_table, emissive_tri)
    num_lights = int((lights["kind"] == light_mod.TRIANGLE).sum()) or 1

    bvh = build_bvh(mesh.vertices, mesh.indices, arity=arity,
                    **(bvh_kwargs or {}))
    device = _build_device(mesh, mat_params, lights, light_ids, bvh,
                           max_path_len, num_lights,
                           tex_images=([tex_images[n] for n in tex_files]
                                       if tex_files else None))
    return CompiledScene(device=device, mesh=mesh,
                         materials=[m.name for m in mats],
                         mat_params=mat_params, num_lights=num_lights,
                         tex_files=tex_files)


def load_data_dir(data_dir):
    """Reads a converter-written data/ directory back into a CompiledScene.

    Reference behavior: the generated main.impala loads every data/*.bin
    buffer through device.load_buffer and the BVH through device.load_bvh
    (converter.cpp:664-680, interface.cpp:432-454); scene.json plays the
    role of the generated code's baked-in constants. Bit-identical to the
    compile_obj route (tested in tests/test_tools.py)."""
    import json
    import struct

    from ..accel import WideBvh
    from ..io import formats

    with open(os.path.join(data_dir, "scene.json")) as f:
        program = json.load(f)
    pad = program.get("padded_vec3", False)
    cols = 4 if pad else 3

    def rvec3(name):
        a = formats.read_lz4_buffer(os.path.join(data_dir, name),
                                    np.float32)
        return np.ascontiguousarray(a.reshape(-1, cols)[:, :3])

    vertices = rvec3("vertices.bin")
    normals = rvec3("normals.bin")
    face_normals = rvec3("face_normals.bin")
    texcoords = formats.read_lz4_buffer(
        os.path.join(data_dir, "texcoords.bin"), np.float32).reshape(-1, 2)
    indices = formats.read_lz4_buffer(
        os.path.join(data_dir, "indices.bin"), np.int32)
    mesh = obj_io.TriMesh(vertices=vertices, normals=normals,
                          face_normals=face_normals, texcoords=texcoords,
                          indices=indices)

    light_ids = formats.read_lz4_buffer(
        os.path.join(data_dir, "light_ids.bin"), np.int32)
    lv_path = os.path.join(data_dir, "light_verts.bin")
    if os.path.exists(lv_path):
        lv = formats.read_lz4_buffer(lv_path, np.float32)
        lv = lv.reshape(-1, cols)[:, :3].reshape(-1, 3, 3)
        inv_area = formats.read_lz4_buffer(
            os.path.join(data_dir, "light_areas.bin"), np.float32)
        ln = formats.read_lz4_buffer(
            os.path.join(data_dir, "light_norms.bin"),
            np.float32).reshape(-1, cols)[:, :3]
        lc = formats.read_lz4_buffer(
            os.path.join(data_dir, "light_colors.bin"),
            np.float32).reshape(-1, cols)[:, :3]
        lights = {
            "kind": np.full(len(inv_area), light_mod.TRIANGLE, np.int32),
            "v0": np.ascontiguousarray(lv[:, 0]),
            "v1": np.ascontiguousarray(lv[:, 1]),
            "v2": np.ascontiguousarray(lv[:, 2]),
            "n": np.ascontiguousarray(ln),
            "inv_area": inv_area,
            "color": np.ascontiguousarray(lc),
        }
    else:
        # dummy black point light (converter.cpp:848-850)
        lights = {
            "kind": np.zeros(1, np.int32),
            "v0": np.zeros((1, 3), np.float32),
            "v1": np.zeros((1, 3), np.float32),
            "v2": np.zeros((1, 3), np.float32),
            "n": np.asarray([[0, 0, 1]], np.float32),
            "inv_area": np.ones(1, np.float32),
            "color": np.zeros((1, 3), np.float32),
        }

    # bvh.bin: [u32 node_bytes][u32 tri_bytes][lz4 nodes][lz4 tris]
    # (converter.cpp:428-438; reader parity: interface.cpp:432-454)
    with open(os.path.join(data_dir, "bvh.bin"), "rb") as f:
        node_bytes, tri_bytes = struct.unpack("<II", f.read(8))
        raw_nodes = formats.read_lz4_buffer(f)
        raw_tris = formats.read_lz4_buffer(f)
    arity = {64: 2, 128: 4, 256: 8}[node_bytes]
    ndt = formats.node_dtype(arity)
    tdt = formats.TRI1_DTYPE if arity == 2 else formats.TRI4_DTYPE
    assert ndt.itemsize == node_bytes and tdt.itemsize == tri_bytes
    btype = {2: formats.BVH2_TRI1, 4: formats.BVH4_TRI4,
             8: formats.BVH8_TRI4}[arity]
    block = formats.BvhBlock(btype,
                             np.frombuffer(raw_nodes.tobytes(), ndt),
                             np.frombuffer(raw_tris.tobytes(), tdt))
    bvh = WideBvh.from_block(block)

    mat_params = []
    names = []
    for m in program["materials"]:
        names.append(m["name"])
        mat_params.append({k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in m.items() if k != "name"})

    tex_files = program.get("textures", [])
    tex_images = None
    if tex_files:
        from . import texture as tx
        tex_images = [tx.load_texture(os.path.join(data_dir, "textures", n))
                      for n in tex_files]

    # same `or 1` floor as compile_obj: a lightless scene keeps the dummy
    # black light so pick_uniform's modulo never divides by zero
    num_lights = program["num_lights"] or 1
    device = _build_device(mesh, mat_params, lights, light_ids, bvh,
                           program["max_path_len"], num_lights,
                           tex_images)
    return CompiledScene(device=device, mesh=mesh, materials=names,
                         mat_params=mat_params,
                         num_lights=num_lights,
                         tex_files=tex_files)


def shell_coverage(device):
    """Fraction of the scene-bbox shell covered by geometry lying within
    2.5% of a shell face — a one-time host-side ENCLOSURE statistic.

    Enclosed interiors (hall-class: walls/floor/ceiling hug the bbox)
    score near 1; open scenes (crown-class: geometry on a base plane
    under open sky) score ~1/6. Paths in enclosed scenes live long
    (nothing escapes), so the persistent pool's live fraction stays
    high and a bigger pool amortizes per-step fixed cost; in open
    scenes most bounces escape, retirement dominates, and film-scatter
    cost grows with pool width. Used by select_render_policy."""
    v = np.asarray(device["vertices"])
    i4 = np.asarray(device["indices"])
    lo, hi = v.min(0), v.max(0)
    ext = np.maximum(hi - lo, 1e-6)
    tri = v[i4[:, :3]]                     # (T, 3, 3)
    cen = tri.mean(1)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    cover = 0.0
    for ax in range(3):
        o1, o2 = (ax + 1) % 3, (ax + 2) % 3
        face_area = ext[o1] * ext[o2]
        for plane in (lo[ax], hi[ax]):
            near = np.abs(cen[:, ax] - plane) < 0.025 * ext[ax]
            cover += min(float(area[near].sum()) / face_area, 1.0)
    return cover / 6.0


def select_render_policy(device, platform=None):
    """kwargs for render_iteration_persistent on this backend (default:
    jax.default_backend()).

    The traversal engine comes from traversal.engine.select_engine.
    Cornell-class scenes (at most DENSE_MAX_PACKETS Tri packets) batch
    retirement every second step: their traversal is so cheap that the
    splat + regeneration block dominates the step (walk engine on the
    H100, cornell 1080x720 spp 4: 190 vs 168 Msamples/s, PERF.md). The
    tiled engine gets staged row compaction. Enclosed interiors
    (shell_coverage >= 0.5) keep paths alive, so they get a 64K pool
    that amortizes the per-step fixed cost over more live slots; open
    scenes keep the default 32K pool."""
    engine = select_engine(device["bvh"], platform)
    pol = {"engine": engine}
    if device["bvh"]["tris"].shape[0] <= DENSE_MAX_PACKETS:
        pol["retire_every"] = 2
    if engine == "tiled":
        pol["compact"] = 5
    if shell_coverage(device) >= 0.5:
        pol["pool"] = 1 << 16
    return pol


def _mat_eq(a, b):
    return (a.ka == b.ka and a.kd == b.kd and a.ks == b.ks and a.ke == b.ke
            and a.ns == b.ns and a.ni == b.ni and a.tf == b.tf
            and a.illum == b.illum and a.map_kd == b.map_kd
            and a.map_ks == b.map_ks and a.map_ke == b.map_ke)
