"""Scene assembly: parsed .ass nodes -> tensor tables on one device.

Counterpart of rlshaders_tpu/scene/build.py: triangulated world-space
geometry, the material table with its texture links (MayaFile,
MayaProjection, bump3d), the texture stack, quad and disk lights, the
skydome, the perspective camera and the render options, read as the
reference's ShaderData::update does. Tables are built in numpy and moved
once to `device`: the card unless the caller asks for the CPU.

Differences from the JAX build, all deliberate:

* no power-of-two padding of the per-triangle tables (it existed to share
  TPU compiles);
* trace sets fold into visibility bits 8 and up, as in the JAX build
  (`Scene.trace_set_names` holds the names by bit); no integrator path
  reads them, and `accel.trace.build_trace_set` builds a query structure
  over one set;
* images are decoded by the port's own PNG decoder (scene/texture.py); a
  JPEG or other format raises. As in the JAX build, a texture file that is
  not found is no texture (id -1), silently;
* a texture file is looked for relative to `base_dir` only. The JAX build
  also searches the directories above it (`..`, `../..`, `../../data`,
  `../../../data`), the testsuite's layout; the port reads nothing outside
  the directory it is given;
* the material table holds the fields the ported shading reads, under the
  JAX names: those of rlGgx, `standard` with its Ksss lobe, rlDisney and
  rlSkin, and the texture, projection and bump columns.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..core import cpu_math
from .ass_parser import Node, parse
from .texture import TextureStack, load_image

# Material type codes
MAT_STANDARD = 0
MAT_GGX = 1
MAT_DISNEY = 2
MAT_SKIN = 3

# Arnold ray-visibility bits (Arnold 4 ai_ray.h)
VIS_CAMERA = 1
VIS_SHADOW = 2
VIS_REFLECTED = 4
VIS_REFRACTED = 8
VIS_SUBSURFACE = 16
VIS_DIFFUSE = 32
VIS_GLOSSY = 64


class Geometry(NamedTuple):
    """Triangle soup, world space. All (T, ...) tensors."""

    v0: torch.Tensor
    e1: torch.Tensor       # v1 - v0
    e2: torch.Tensor       # v2 - v0
    n0: torch.Tensor       # per-corner shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor      # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor   # (T,) int32
    mesh_id: torch.Tensor  # (T,) int32
    visibility: torch.Tensor  # (T,) int32 ray-visibility bitmask
    opaque: torch.Tensor   # (T,) bool
    receive_shadows: torch.Tensor  # (T,) bool


class Materials(NamedTuple):
    """Material table, (M, ...) tensors; mtype selects the shading model."""

    mtype: torch.Tensor
    kd_color: torch.Tensor         # (M, 3)
    kd: torch.Tensor
    kd_tex: torch.Tensor           # (M,) texture id or -1
    kd_tex_gain: torch.Tensor      # (M, 3) MayaFile colorGain
    kd_tex_offset: torch.Tensor    # (M, 3) MayaFile colorOffset
    kd_tex_invs: torch.Tensor      # (M,) bool: MayaFile `invert`, applied
    #                                in storage space, before the decode
    kd_proj: torch.Tensor          # (M,) 0 mesh uv, 1 planar (defaultColor
    #                                outside), 2 planar wrapping
    kd_proj_inv: torch.Tensor      # (M, 4, 4) world -> projection matrix
    kd_proj_default: torch.Tensor  # (M, 3) colour outside the projection
    diffuse_roughness: torch.Tensor
    ks_color: torch.Tensor         # (M, 3)
    ks: torch.Tensor
    spec_fresnel_mode: torch.Tensor  # 0 dielectric IOR, 1 Schlick, 2 none
    spec_ksn: torch.Tensor
    ks_tex: torch.Tensor           # (M,) texture (alpha = luminance) or -1
    ks_proj: torch.Tensor          # (M,) 0 uv, 1 or 2 planar
    ks_proj_inv: torch.Tensor      # (M, 4, 4)
    bump_tex: torch.Tensor         # (M,) bump height map or -1
    bump_proj: torch.Tensor        # (M,)
    bump_proj_inv: torch.Tensor    # (M, 4, 4)
    bump_height: torch.Tensor      # (M,)
    spec_roughness: torch.Tensor
    spec_aniso: torch.Tensor
    spec_dist: torch.Tensor        # 0 GGX, 1 Beckmann (cook_torrance)
    glossy_caustics: torch.Tensor  # (M,) bool
    kt_color: torch.Tensor         # (M, 3)
    kt: torch.Tensor
    ior: torch.Tensor
    opacity: torch.Tensor          # (M, 3)
    emission: torch.Tensor         # (M, 3)
    subsurface: torch.Tensor       # rlDisney lobe weights
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    indirect_diffuse_scale: torch.Tensor   # rlDisney's indirect multipliers
    indirect_specular_scale: torch.Tensor
    sss_color: torch.Tensor        # (M, 3)
    sss_weight: torch.Tensor
    sss_dist: torch.Tensor         # (M, 3) scatter distance * multiplier
    cavity_fadeout: torch.Tensor   # (M,) bool
    skin_spec_color: torch.Tensor  # (M, 3) rlSkin specular lobe
    skin_spec_weight: torch.Tensor
    skin_spec_roughness: torch.Tensor
    skin_spec_ior: torch.Tensor
    skin_sheen_color: torch.Tensor  # (M, 3) rlSkin sheen lobe
    skin_sheen_weight: torch.Tensor
    skin_sheen_roughness: torch.Tensor
    skin_sheen_ior: torch.Tensor


class QuadLights(NamedTuple):
    """(L, ...) quad area lights; L >= 1 with a mask for the empty slot."""

    verts: torch.Tensor      # (L, 4, 3) world space
    radiance: torch.Tensor   # (L, 3) emitted radiance (normalize/area folded)
    normal: torch.Tensor     # (L, 3)
    area: torch.Tensor       # (L,)
    samples: tuple           # per-light sample counts n (n^2 samples)
    affect_diffuse: tuple
    affect_specular: tuple
    diffuse_weight: tuple
    specular_weight: tuple
    valid: tuple


class DiskLights(NamedTuple):
    """(L, ...) disk area lights; L >= 1 with a mask for the empty slot."""

    center: torch.Tensor     # (L, 3)
    u: torch.Tensor          # (L, 3) radius-scaled basis
    v: torch.Tensor
    normal: torch.Tensor     # (L, 3) emission is along -normal
    radius: torch.Tensor     # (L,)
    radiance: torch.Tensor   # (L, 3)
    area: torch.Tensor       # (L,)
    samples: tuple           # per-light sample counts n (n^2 samples)
    affect_diffuse: tuple
    affect_specular: tuple
    valid: tuple


class SkyLight(NamedTuple):
    radiance: torch.Tensor   # (3,)
    samples: int
    affect_diffuse: bool
    affect_specular: bool
    exists: bool


class Camera(NamedTuple):
    c2w: torch.Tensor        # (4, 4) row-vector convention (rows = basis)
    fov_deg: float
    focus_distance: float
    aperture_size: float
    xres: int
    yres: int


@dataclass
class RenderOptions:
    aa_samples: int = 3
    gi_diffuse_depth: int = 1
    gi_glossy_depth: int = 1
    gi_refraction_depth: int = 6
    gi_total_depth: int = 12
    gi_diffuse_samples: int = 3
    gi_glossy_samples: int = 3
    gi_refraction_samples: int = 3
    gi_sss_samples: int = 3
    xres: int = 256
    yres: int = 256
    texture_gamma: float = 1.0
    light_gamma: float = 1.0
    shader_gamma: float = 1.0
    aa_seed: int = 100
    filter_width: float = 2.0


@dataclass
class Scene:
    geometry: Geometry
    materials: Materials
    quad_lights: QuadLights
    disk_lights: DiskLights
    sky: SkyLight
    camera: Camera
    textures: TextureStack
    options: RenderOptions
    mesh_names: list = field(default_factory=list)
    material_names: list = field(default_factory=list)
    trace_set_names: list = field(default_factory=list)

    @property
    def device(self) -> torch.device:
        return self.geometry.v0.device


def _xform_points(pts: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Row-vector transform: p' = p @ M[:3,:3] + M[3,:3]."""
    return pts @ m[:3, :3] + m[3, :3]


def _xform_normals(ns: np.ndarray, m: np.ndarray) -> np.ndarray:
    out = ns @ np.linalg.inv(m[:3, :3]).T
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-20)


def _gamma_rgb(c, gamma: float) -> np.ndarray:
    c = np.asarray(c, np.float32)
    if c.ndim == 0:
        c = np.full(3, float(c), np.float32)
    return np.power(np.maximum(c, 0.0), gamma).astype(np.float32)


def _triangulate(nsides, idxs: np.ndarray) -> np.ndarray:
    """Fan-triangulate polygons; returns (T, 3) corner rows of idxs."""
    if np.isscalar(nsides) or np.ndim(nsides) == 0:
        nsides = (np.full(1, int(nsides), np.int32) if int(nsides) > 2
                  else np.zeros(0, np.int32))
    nsides = np.asarray(nsides, np.int64)
    offs = np.concatenate([[0], np.cumsum(nsides)])
    tri_rows = []
    for fi, n in enumerate(nsides):
        o = offs[fi]
        for k in range(1, n - 1):
            tri_rows.append((o, o + k, o + k + 1))
    return idxs[np.asarray(tri_rows, np.int64)]


def _tensor(a, device) -> torch.Tensor:
    """numpy -> tensor on device: floats as float32, ints as int32."""
    a = np.array(a)
    dtype = {"f": torch.float32, "i": torch.int32, "u": torch.int32,
             "b": torch.bool}[a.dtype.kind]
    return torch.as_tensor(a, device=device).to(dtype)


def build(path_or_nodes, device="cuda", base_dir: str | None = None
          ) -> Scene:
    """Assemble a Scene from an .ass path or a pre-parsed node list, with
    every table on `device` (the card by default; "cpu" for the CPU).
    Texture file names are relative to `base_dir`: by default the scene
    file's directory, or "." for a node list."""
    if torch.device(device).type == "cpu":
        cpu_math.settle()
    if isinstance(path_or_nodes, str):
        nodes = parse(path_or_nodes)
        base_dir = base_dir or os.path.dirname(os.path.abspath(path_or_nodes))
    else:
        nodes = path_or_nodes
        base_dir = base_dir or "."

    by_name: dict[str, Node] = {n.name: n for n in nodes if n.name}
    opts_node = next(n for n in nodes if n.type == "options")

    opts = RenderOptions(
        aa_samples=int(opts_node.get("AA_samples", 1)),
        gi_diffuse_depth=int(opts_node.get("GI_diffuse_depth", 0)),
        gi_glossy_depth=int(opts_node.get("GI_glossy_depth", 0)),
        gi_refraction_depth=int(opts_node.get("GI_refraction_depth", 0)),
        gi_total_depth=int(opts_node.get("GI_total_depth", 0)),
        gi_diffuse_samples=int(opts_node.get("GI_diffuse_samples", 1)),
        gi_glossy_samples=int(opts_node.get("GI_glossy_samples", 1)),
        gi_refraction_samples=int(opts_node.get("GI_refraction_samples", 1)),
        gi_sss_samples=int(opts_node.get("GI_sss_samples", 1)),
        xres=int(opts_node.get("xres", 256)),
        yres=int(opts_node.get("yres", 256)),
        texture_gamma=float(opts_node.get("texture_gamma", 1.0)),
        light_gamma=float(opts_node.get("light_gamma", 1.0)),
        shader_gamma=float(opts_node.get("shader_gamma", 1.0)),
        aa_seed=int(opts_node.get("AA_seed", 0)),
    )
    # pixel filter: the options `outputs` line names the filter node
    outputs = opts_node.get("outputs", "")
    for tok in (outputs.split() if isinstance(outputs, str) else []):
        fnode = by_name.get(tok)
        if fnode is not None and fnode.type.endswith("_filter"):
            opts.filter_width = float(fnode.get("width", 2.0))
            break

    # ---------------- camera ----------------
    cam_node = by_name.get(opts_node.get("camera")) or next(
        n for n in nodes if n.type == "persp_camera")
    camera = Camera(
        c2w=_tensor(np.asarray(cam_node.get("matrix"), np.float32), device),
        fov_deg=float(cam_node.get("fov", 54.43)),
        focus_distance=float(cam_node.get("focus_distance", 1.0)),
        aperture_size=float(cam_node.get("aperture_size", 0.0)),
        xres=opts.xres,
        yres=opts.yres,
    )

    # ---------------- textures ----------------
    tex_paths: list[str] = []
    tex_images: list[np.ndarray] = []
    no_tex = {
        "tex_id": -1, "gain": np.ones(3, np.float32),
        "offset": np.zeros(3, np.float32), "invs": False, "proj": 0,
        "proj_inv": np.eye(4, dtype=np.float32),
        "proj_default": np.full(3, 0.5, np.float32),
    }

    def load_texture_slot(fname: str) -> int:
        """The texture id of `fname`, relative to `base_dir` only; -1 where
        it is not found (no texture, as in the JAX build)."""
        p = os.path.abspath(os.path.join(base_dir, fname))
        if not os.path.exists(p):
            return -1
        if p not in tex_paths:
            tex_paths.append(p)
            # storage space: texture_gamma is applied after the filter taps
            # (models/dispatch._degamma)
            tex_images.append(load_image(p))
        return tex_paths.index(p)

    def resolve_tex_input(node_or_name) -> dict:
        """A MayaFile or MayaProjection link as a texture descriptor: the
        texture id, colorGain and colorOffset (a projection's chained on
        its file's), `invert`, and a planar projection's placement."""
        node = (by_name.get(node_or_name) if isinstance(node_or_name, str)
                else node_or_name)
        if node is None:
            return dict(no_tex)
        if node.type == "MayaProjection":
            out = resolve_tex_input(node.get("image"))
            pm = np.asarray(node.get("placementMatrix",
                                     np.eye(4, dtype=np.float32)),
                            np.float32).reshape(4, 4)
            # proj 1: planar with defaultColor outside the unit square;
            # proj 2: planar with `wrap on` (the image tiles outside it)
            out["proj"] = 2 if bool(node.get("wrap", True)) else 1
            # placementMatrix already maps world -> projection space
            full = np.eye(4, dtype=np.float32)
            full[:3, :3] = pm[:3, :3]
            full[3, :3] = pm[3, :3]
            out["proj_inv"] = full
            out["proj_default"] = _gamma_rgb(node.get("defaultColor", 0.5),
                                             opts.texture_gamma)
            g = _gamma_rgb(node.get("colorGain", 1.0), 1.0)
            o = _gamma_rgb(node.get("colorOffset", 0.0), 1.0)
            out["gain"] = out["gain"] * g
            out["offset"] = out["offset"] * g + o
            return out
        if node.type != "MayaFile":
            return dict(no_tex)
        # colour = decode(invert(tex)) * colorGain + colorOffset: `invert`
        # in storage space before the texture_gamma decode, gain and offset
        # in linear space after it
        return dict(no_tex,
                    tex_id=load_texture_slot(node.get("filename", "")),
                    gain=_gamma_rgb(node.get("colorGain", 1.0), 1.0),
                    offset=_gamma_rgb(node.get("colorOffset", 0.0), 1.0),
                    invs=bool(node.get("invert", False)))

    def kd_columns(v, gamma) -> dict:
        """A colour parameter as an RGB value or a texture link: the row's
        kd_color and kd_tex* / kd_proj* columns."""
        if isinstance(v, str):
            c, t = np.ones(3, np.float32), resolve_tex_input(v)
        else:
            c, t = _gamma_rgb(v, gamma), dict(no_tex)
        return {"kd_color": c, "kd_tex": t["tex_id"],
                "kd_tex_gain": t["gain"], "kd_tex_offset": t["offset"],
                "kd_tex_invs": t["invs"], "kd_proj": t["proj"],
                "kd_proj_inv": t["proj_inv"],
                "kd_proj_default": t["proj_default"]}

    def scalar_or_link(v, default=0.0):
        """A scalar parameter or a link to a texture's alpha ('node.a',
        which samples the luminance): (value, descriptor)."""
        if isinstance(v, str):
            return 1.0, resolve_tex_input(v.split(".")[0])
        val = float(v) if isinstance(v, (int, float)) else default
        return val, dict(no_tex)

    # ---------------- materials ----------------
    def resolve_surface(shader_name: str):
        """MayaShadingEngine/bump3d indirection -> (surface shader node,
        bump3d node or None)."""
        node = by_name.get(shader_name)
        bump = None
        for _ in range(4):
            if node is None:
                return None, bump
            if node.type == "MayaShadingEngine":
                node = by_name.get(node.get("beauty", ""))
            elif node.type == "bump3d":
                bump = node
                node = by_name.get(node.get("shader", ""))
            else:
                return node, bump
        return node, bump

    def fnum(v, default=0.0):
        return float(v) if isinstance(v, (int, float)) else default

    mat_rows: list[dict] = []
    mat_index: dict[str, int] = {}
    material_names: list[str] = []

    def material_id_for(shader_name: str) -> int:
        if shader_name in mat_index:
            return mat_index[shader_name]
        node, bump_node = resolve_surface(shader_name)
        g = opts.shader_gamma
        row = {
            "mtype": MAT_STANDARD, "kd": 0.0, **kd_columns(1.0, 1.0),
            "diffuse_roughness": 0.0,
            "ks_color": np.ones(3, np.float32), "ks": 0.0,
            "spec_fresnel_mode": 0, "spec_ksn": 0.04,
            "ks_tex": -1, "ks_proj": 0,
            "ks_proj_inv": np.eye(4, dtype=np.float32),
            "bump_tex": -1, "bump_proj": 0,
            "bump_proj_inv": np.eye(4, dtype=np.float32), "bump_height": 0.0,
            "spec_roughness": 0.4, "spec_aniso": 0.0, "spec_dist": 0,
            "glossy_caustics": True,
            "kt_color": np.ones(3, np.float32), "kt": 0.0, "ior": 1.0,
            "opacity": np.ones(3, np.float32),
            "emission": np.zeros(3, np.float32),
            "subsurface": 0.0, "metallic": 0.0, "specular": 0.0,
            "specular_tint": 0.0, "sheen": 0.0, "sheen_tint": 0.0,
            "clearcoat": 0.0, "clearcoat_gloss": 0.0,
            "indirect_diffuse_scale": 1.0, "indirect_specular_scale": 1.0,
            "sss_color": np.ones(3, np.float32), "sss_weight": 0.0,
            "sss_dist": np.ones(3, np.float32), "cavity_fadeout": True,
            "skin_spec_color": np.ones(3, np.float32),
            "skin_spec_weight": 0.0, "skin_spec_roughness": 0.5,
            "skin_spec_ior": 1.44,
            "skin_sheen_color": np.ones(3, np.float32),
            "skin_sheen_weight": 0.0, "skin_sheen_roughness": 0.35,
            "skin_sheen_ior": 1.44,
        }
        if node is not None and node.type == "rlGgx":
            row.update(
                mtype=MAT_GGX, **kd_columns(node.get("KdColor", 1.0), g),
                kd=fnum(node.get("Kd", 0.5)),
                diffuse_roughness=fnum(node.get("diffuseRoughness", 0.0)),
                ks_color=_gamma_rgb(node.get("KsColor", 1.0), g),
                ks=fnum(node.get("Ks", 0.5)),
                spec_roughness=fnum(node.get("specularRoughness", 0.0)),
                spec_aniso=fnum(node.get("anisotropic", 0.0)),
                kt_color=_gamma_rgb(node.get("KtColor", 1.0), g),
                kt=fnum(node.get("Kt", 0.0)),
                ior=fnum(node.get("ior", 1.0), 1.0),
                opacity=fnum(node.get("opacity", 1.0))
                * _gamma_rgb(node.get("opacity_color", 1.0), 1.0),
            )
        elif node is not None and node.type == "rlDisney":
            row.update(
                mtype=MAT_DISNEY, **kd_columns(node.get("base_color", 1.0), g),
                subsurface=fnum(node.get("subsurface", 0.0)),
                metallic=fnum(node.get("metallic", 0.0)),
                specular=fnum(node.get("specular", 0.0)),
                specular_tint=fnum(node.get("specular_tint", 0.0)),
                spec_roughness=fnum(node.get("roughness", 0.0)),
                spec_aniso=fnum(node.get("anisotropic", 0.0)),
                sheen=fnum(node.get("sheen", 0.0)),
                sheen_tint=fnum(node.get("sheen_tint", 0.0)),
                clearcoat=fnum(node.get("clearcoat", 0.0)),
                clearcoat_gloss=fnum(node.get("clearcoat_gloss", 0.0)),
                indirect_diffuse_scale=fnum(
                    node.get("indirectDiffuseScale", 1.0), 1.0),
                indirect_specular_scale=fnum(
                    node.get("indirectSpecularScale", 1.0), 1.0),
                opacity=_gamma_rgb(node.get("opacity", 1.0), 1.0),
            )
        elif node is not None and node.type == "rlSkin":
            # the colours carry always_linear metadata: no shader gamma
            row.update(
                mtype=MAT_SKIN,
                sss_color=_gamma_rgb(node.get("sss_color", 1.0), 1.0),
                sss_weight=fnum(node.get("sss_weight", 1.0), 1.0),
                sss_dist=fnum(node.get("sss_dist_multiplier", 1.0), 1.0)
                * np.asarray(node.get("sss_scatter_dist", np.ones(3)),
                             np.float32),
                cavity_fadeout=bool(node.get("sss_cavity_fadeout", True)),
                skin_spec_color=_gamma_rgb(node.get("specular_color", 1.0),
                                           1.0),
                skin_spec_weight=fnum(node.get("specular_weight", 0.6)),
                skin_spec_roughness=fnum(node.get("specular_roughness", 0.5)),
                skin_spec_ior=fnum(node.get("specular_ior", 1.44), 1.44),
                skin_sheen_color=_gamma_rgb(node.get("sheen_color", 1.0), 1.0),
                skin_sheen_weight=fnum(node.get("sheen_weight", 0.0)),
                skin_sheen_roughness=fnum(node.get("sheen_roughness", 0.35)),
                skin_sheen_ior=fnum(node.get("sheen_ior", 1.44), 1.44),
                opacity=fnum(node.get("opacity", 1.0))
                * _gamma_rgb(node.get("opacity_color", 1.0), 1.0),
            )
        elif node is not None and node.type == "standard":
            # a linked Ks ('node.a') reads as Ks 0 with no texture: the
            # reference's MayaFile gives alpha 0 for alpha-less images on
            # the scalar path (a bump3d's '.a' link reads the luminance)
            ks_raw = node.get("Ks", 0.0)
            ks_val, ks_t = ((0.0, dict(no_tex)) if isinstance(ks_raw, str)
                            else scalar_or_link(ks_raw))
            row.update(
                mtype=MAT_STANDARD, **kd_columns(node.get("Kd_color", 1.0), g),
                kd=fnum(node.get("Kd", 0.7)),
                diffuse_roughness=fnum(node.get("diffuse_roughness", 0.0)),
                # a linked Ks_color reads as 1 (its texture is dropped)
                ks_color=(np.ones(3, np.float32)
                          if isinstance(node.get("Ks_color"), str)
                          else _gamma_rgb(node.get("Ks_color", 1.0), g)),
                ks=ks_val, ks_tex=ks_t["tex_id"], ks_proj=ks_t["proj"],
                ks_proj_inv=ks_t["proj_inv"],
                spec_fresnel_mode=(
                    1 if bool(node.get("specular_Fresnel", False)) else 2),
                spec_ksn=scalar_or_link(node.get("Ksn", 0.0))[0],
                spec_roughness=fnum(node.get("specular_roughness", 0.47)),
                spec_aniso=0.0,
                spec_dist=0 if node.get("specular_brdf") == "ggx" else 1,
                glossy_caustics=bool(
                    node.get("enable_glossy_caustics", False)),
                ior=1.0,
                emission=fnum(node.get("emission", 0.0))
                * _gamma_rgb(node.get("emission_color", 1.0), g),
                opacity=_gamma_rgb(node.get("opacity", 1.0), 1.0),
                # the Ksss lobe rides rlSkin's probe stage (integrator/sss.py)
                sss_weight=fnum(node.get("Ksss", 0.0)),
                sss_color=_gamma_rgb(node.get("Ksss_color", 1.0), g),
                sss_dist=np.asarray(node.get("sss_radius", [0.1, 0.1, 0.1]),
                                    np.float32).reshape(3),
                cavity_fadeout=False,
            )
        if bump_node is not None and isinstance(bump_node.get("bump_map"),
                                                str):
            bt = resolve_tex_input(bump_node.get("bump_map").split(".")[0])
            row.update(bump_tex=bt["tex_id"], bump_proj=bt["proj"],
                       bump_proj_inv=bt["proj_inv"],
                       bump_height=fnum(bump_node.get("bump_height", 0.0)))
        mat_rows.append(row)
        mat_index[shader_name] = len(mat_rows) - 1
        material_names.append(shader_name)
        return mat_index[shader_name]

    # ---------------- geometry ----------------
    V0, E1, E2, N0, N1, N2, UV0, UV1, UV2 = ([] for _ in range(9))
    MATID, MESHID, VIS, OPQ, RCV = ([] for _ in range(5))
    mesh_names = []
    trace_set_names: list[str] = []
    for n in nodes:
        if n.type != "polymesh":
            continue
        mid = len(mesh_names)
        mesh_names.append(n.name)
        m = np.asarray(n.get("matrix", np.eye(4, dtype=np.float32)),
                       np.float32)
        vlist = np.asarray(n.get("vlist"), np.float32).reshape(-1, 3)
        vidxs = np.asarray(n.get("vidxs"), np.int64).reshape(-1)
        nsides = n.get("nsides", 4)
        corner = _triangulate(nsides, vidxs)
        vw = _xform_points(vlist, m)
        p0, p1, p2 = vw[corner[:, 0]], vw[corner[:, 1]], vw[corner[:, 2]]

        nlist = n.get("nlist")
        nidxs = n.get("nidxs")
        if nlist is not None and nidxs is not None:
            nlist = np.asarray(nlist, np.float32).reshape(-1, 3)
            nidxs = np.asarray(nidxs, np.int64).reshape(-1)
            ncorner = _triangulate(nsides, nidxs)
            nw = _xform_normals(nlist, m)
            nn0, nn1, nn2 = (nw[ncorner[:, 0]], nw[ncorner[:, 1]],
                             nw[ncorner[:, 2]])
        else:
            gn = np.cross(p1 - p0, p2 - p0)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                             1e-20)
            nn0 = nn1 = nn2 = gn

        uvlist = n.get("uvlist")
        uvidxs = n.get("uvidxs")
        if uvlist is not None and uvidxs is not None:
            uvlist = np.asarray(uvlist, np.float32).reshape(-1, 2)
            uvidxs = np.asarray(uvidxs, np.int64).reshape(-1)
            uvcorner = _triangulate(nsides, uvidxs)
            u0, u1, u2 = (uvlist[uvcorner[:, 0]], uvlist[uvcorner[:, 1]],
                          uvlist[uvcorner[:, 2]])
        else:
            u0 = u1 = u2 = np.zeros((corner.shape[0], 2), np.float32)

        t = corner.shape[0]
        mat = material_id_for(n.get("shader", ""))
        V0.append(p0); E1.append(p1 - p0); E2.append(p2 - p0)
        N0.append(nn0); N1.append(nn1); N2.append(nn2)
        UV0.append(u0); UV1.append(u1); UV2.append(u2)
        MATID.append(np.full(t, mat, np.int32))
        MESHID.append(np.full(t, mid, np.int32))
        # trace sets (Arnold's AiShaderGlobalsSetTraceSet): a mesh's set
        # names fold into visibility bits 8.. (the ray-visibility bits all
        # fit in 0..7), so every reader masks before it compares
        ts = n.get("trace_sets")
        set_bits = 0
        if ts:
            for name in ([ts] if isinstance(ts, str) else list(ts)):
                if name not in trace_set_names:
                    trace_set_names.append(name)
                set_bits |= 1 << (8 + trace_set_names.index(name))
        VIS.append(np.full(
            t, int(n.get("visibility", 255)) | set_bits, np.int32))
        OPQ.append(np.full(t, bool(n.get("opaque", True))))
        RCV.append(np.full(t, bool(n.get("receive_shadows", True))))

    def cat(xs):
        return np.concatenate(xs, axis=0)

    # Effective shadow opacity: `opaque off` evaluates the shader's opacity
    # for shadow rays, so a material with Kt = 0 and opacity 1 still blocks
    matid_all = cat(MATID)
    kt_m = np.asarray([float(r["kt"]) for r in mat_rows], np.float32)
    op_m = np.asarray([float(np.min(r["opacity"])) for r in mat_rows],
                      np.float32)
    mat_blocks = (kt_m[matid_all] <= 1e-5) & (op_m[matid_all] >= 1.0 - 1e-5)
    opq_eff = cat(OPQ) | mat_blocks

    geometry = Geometry(
        v0=_tensor(cat(V0), device), e1=_tensor(cat(E1), device),
        e2=_tensor(cat(E2), device),
        n0=_tensor(cat(N0), device), n1=_tensor(cat(N1), device),
        n2=_tensor(cat(N2), device),
        uv0=_tensor(cat(UV0), device), uv1=_tensor(cat(UV1), device),
        uv2=_tensor(cat(UV2), device),
        mat_id=_tensor(matid_all, device),
        mesh_id=_tensor(cat(MESHID), device),
        visibility=_tensor(cat(VIS), device), opaque=_tensor(opq_eff, device),
        receive_shadows=_tensor(cat(RCV), device),
    )
    materials = Materials(**{
        f: _tensor(np.stack([np.asarray(r[f]) for r in mat_rows]), device)
        for f in Materials._fields
    })

    # ---------------- lights ----------------
    lg = opts.light_gamma

    def light_radiance(n: Node, area: float) -> np.ndarray:
        c = _gamma_rgb(n.get("color", 1.0), lg)
        rad = c * float(n.get("intensity", 1.0)) * (
            2.0 ** float(n.get("exposure", 0.0)))
        if bool(n.get("normalize", True)) and area > 0:
            rad = rad / area
        return rad.astype(np.float32)

    qv, qr, qn, qa, qs, qad, qas, qdw, qsw = ([] for _ in range(9))
    for n in nodes:
        if n.type != "quad_light":
            continue
        m = np.asarray(n.get("matrix"), np.float32)
        verts = _xform_points(
            np.asarray(n.get("vertices"), np.float32).reshape(4, 3), m)
        e1 = verts[1] - verts[0]
        e2 = verts[3] - verts[0]
        nrm = np.cross(e1, e2)
        area = float(np.linalg.norm(nrm))  # parallelogram quad
        nrm /= max(np.linalg.norm(nrm), 1e-20)
        qv.append(verts)
        qa.append(area)
        qn.append(nrm)
        qr.append(light_radiance(n, area))
        qs.append(int(n.get("samples", 1)))
        qad.append(bool(n.get("affect_diffuse", True)))
        qas.append(bool(n.get("affect_specular", True)))
        qdw.append(float(n.get("diffuse", 1.0)))
        qsw.append(float(n.get("specular", 1.0)))
    valid = [float(np.sum(r)) != 0.0 or len(qv) > 1 for r in qr]
    if not qv:
        qv = [np.zeros((4, 3), np.float32)]
        qr = [np.zeros(3, np.float32)]
        qn = [np.array([0, 0, 1], np.float32)]
        qa = [1.0]; qs = [1]; qad = [False]; qas = [False]
        qdw = [0.0]; qsw = [0.0]; valid = [False]
    quad_lights = QuadLights(
        verts=_tensor(np.stack(qv), device),
        radiance=_tensor(np.stack(qr), device),
        normal=_tensor(np.stack(qn), device),
        area=_tensor(np.asarray(qa, np.float32), device),
        samples=tuple(qs), affect_diffuse=tuple(qad),
        affect_specular=tuple(qas), diffuse_weight=tuple(qdw),
        specular_weight=tuple(qsw), valid=tuple(valid),
    )

    dc, du, dv, dn, drad, dr, da, ds, dad, das = ([] for _ in range(10))
    for n in nodes:
        if n.type != "disk_light":
            continue
        m = np.asarray(n.get("matrix"), np.float32)
        radius = float(n.get("radius", 0.5))
        # MtoA writes the light's scale into the matrix and mirrors it in
        # `radius`: the matrix scale where it has one, else the radius,
        # never both
        row_scale = float(np.linalg.norm(m[0, :3]))
        k = (1.0 if row_scale > 1e-6 and abs(row_scale - 1.0) > 1e-4
             else radius)
        u = m[0, :3] * k
        v = m[1, :3] * k
        area = float(np.pi * np.linalg.norm(np.cross(u, v)))
        dc.append(m[3, :3].copy())
        du.append(u)
        dv.append(v)
        dn.append(-m[2, :3] / max(np.linalg.norm(m[2, :3]), 1e-20))
        dr.append(radius)
        da.append(area)
        drad.append(light_radiance(n, area))
        ds.append(int(n.get("samples", 1)))
        dad.append(bool(n.get("affect_diffuse", True)))
        das.append(bool(n.get("affect_specular", True)))
    if not dc:
        # the placeholder row of a scene without disk lights
        dc = [np.zeros(3, np.float32)]; du = [np.array([1, 0, 0], np.float32)]
        dv = [np.array([0, 1, 0], np.float32)]
        dn = [np.array([0, 0, 1], np.float32)]
        dr = [1.0]; da = [1.0]; drad = [np.zeros(3, np.float32)]; ds = [1]
        dad = [False]; das = [False]
    disk_lights = DiskLights(
        center=_tensor(np.stack(dc), device), u=_tensor(np.stack(du), device),
        v=_tensor(np.stack(dv), device), normal=_tensor(np.stack(dn), device),
        radius=_tensor(np.asarray(dr, np.float32), device),
        radiance=_tensor(np.stack(drad), device),
        area=_tensor(np.asarray(da, np.float32), device),
        samples=tuple(ds), affect_diffuse=tuple(dad),
        affect_specular=tuple(das),
        valid=tuple(bool(np.any(r > 0)) for r in drad),
    )

    sky_node = next((n for n in nodes if n.type == "skydome_light"), None)
    if sky_node is not None:
        sky = SkyLight(
            radiance=_tensor(light_radiance(sky_node, 0.0), device),
            samples=int(sky_node.get("samples", 1)),
            affect_diffuse=bool(sky_node.get("affect_diffuse", True)),
            affect_specular=bool(sky_node.get("affect_specular", True)),
            exists=True,
        )
    else:
        sky = SkyLight(radiance=torch.zeros(3, device=device), samples=1,
                       affect_diffuse=False, affect_specular=False,
                       exists=False)

    return Scene(
        geometry=geometry, materials=materials, quad_lights=quad_lights,
        disk_lights=disk_lights, sky=sky, camera=camera,
        textures=TextureStack.build(tex_images, device), options=opts,
        mesh_names=mesh_names, material_names=material_names,
        trace_set_names=trace_set_names,
    )


def build_text(text: str, device="cuda", base_dir: str | None = None
               ) -> Scene:
    """Build from .ass source text (a temporary file feeds the parser);
    texture file names are relative to `base_dir` (by default the temporary
    file's directory)."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".ass")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        return build(path, device, base_dir)
    finally:
        os.unlink(path)
