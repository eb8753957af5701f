"""Scene tables handed over as numpy arrays.

`scene_from_numpy` builds the port's `Scene` and `Accel` from a flat dict
of arrays named "<table>.<field>", with the tables and fields of the JAX
package's scene (geometry, materials, quad_lights, disk_lights, sky,
camera, textures, options) and its BVH (bvh.bbox_min ... bvh.tri_order). Fields the port does not
read are ignored. It lets the port's integrator run on exactly the inputs
of the JAX one, independently of the port's own `build`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .accel import trace as tracemod
from .core import cpu_math
from .scene import build as buildmod
from .scene import texture as texmod


def scene_tables(scene, accel) -> dict[str, np.ndarray]:
    """The flat "<table>.<field>" dict of a scene and its accel, read with
    np.asarray: works on this package's CPU scenes and, unchanged, on the
    JAX package's (its tables are NamedTuples of arrays too)."""
    out = {}
    for name in ("geometry", "materials", "quad_lights", "disk_lights", "sky",
                 "camera", "textures"):
        table = getattr(scene, name)
        for f in table._fields:
            out[f"{name}.{f}"] = np.asarray(getattr(table, f))
    for f in dataclasses.fields(scene.options):
        out[f"options.{f.name}"] = np.asarray(getattr(scene.options, f.name))
    for f in accel.tree._fields:
        out[f"bvh.{f}"] = np.asarray(getattr(accel.tree, f))
    return out


def _table(cls, tables: dict, name: str, device):
    return cls(**{f: buildmod._tensor(tables[f"{name}.{f}"], device)
                  for f in cls._fields})


def _scalar(tables: dict, key: str):
    return np.asarray(tables[key]).item()


def scene_from_numpy(tables: dict[str, np.ndarray], device):
    """(Scene, Accel) on `device` from the JAX package's tables."""
    if torch.device(device).type == "cpu":
        cpu_math.settle()
    geometry = _table(buildmod.Geometry, tables, "geometry", device)
    materials = _table(buildmod.Materials, tables, "materials", device)

    def t(key):
        return buildmod._tensor(tables[key], device)

    def host(table, f, cast):
        return tuple(cast(x) for x in
                     np.asarray(tables[f"{table}.{f}"]).reshape(-1))

    quad_lights = buildmod.QuadLights(
        verts=t("quad_lights.verts"),
        radiance=t("quad_lights.radiance"),
        normal=t("quad_lights.normal"),
        area=t("quad_lights.area"),
        **{f: host("quad_lights", f, cast) for f, cast in (
            ("samples", int), ("affect_diffuse", bool),
            ("affect_specular", bool), ("diffuse_weight", float),
            ("specular_weight", float), ("valid", bool))},
    )
    disk_lights = buildmod.DiskLights(
        **{f: t(f"disk_lights.{f}") for f in (
            "center", "u", "v", "normal", "radius", "radiance", "area")},
        **{f: host("disk_lights", f, cast) for f, cast in (
            ("samples", int), ("affect_diffuse", bool),
            ("affect_specular", bool), ("valid", bool))},
    )
    textures = _table(texmod.TextureStack, tables, "textures", device)
    sky = buildmod.SkyLight(
        radiance=t("sky.radiance"),
        samples=int(_scalar(tables, "sky.samples")),
        affect_diffuse=bool(_scalar(tables, "sky.affect_diffuse")),
        affect_specular=bool(_scalar(tables, "sky.affect_specular")),
        exists=bool(_scalar(tables, "sky.exists")),
    )
    camera = buildmod.Camera(
        c2w=t("camera.c2w"),
        fov_deg=float(_scalar(tables, "camera.fov_deg")),
        focus_distance=float(_scalar(tables, "camera.focus_distance")),
        aperture_size=float(_scalar(tables, "camera.aperture_size")),
        xres=int(_scalar(tables, "camera.xres")),
        yres=int(_scalar(tables, "camera.yres")),
    )
    options = buildmod.RenderOptions(**{
        f.name: type(f.default)(_scalar(tables, f"options.{f.name}"))
        for f in dataclasses.fields(buildmod.RenderOptions)
    })
    scene = buildmod.Scene(geometry=geometry, materials=materials,
                           quad_lights=quad_lights, disk_lights=disk_lights,
                           sky=sky, camera=camera, textures=textures,
                           options=options)
    accel = tracemod.from_arrays(
        geometry, *(tables[f"bvh.{f}"] for f in
                    ("bbox_min", "bbox_max", "first", "count", "miss",
                     "tri_order")))
    return scene, accel
