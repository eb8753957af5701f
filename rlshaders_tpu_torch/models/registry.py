"""Shader registry + parameter metadata.

The TPU-native counterpart of the reference's plugin surface:

* `_PluginMain.cpp`'s `node_loader` exporting the three shader nodes by
  name/type (reference _PluginMain.cpp:16-47) -> `SHADERS`, a registry
  mapping node-type names to parameter schemas and the dispatch model id;
* `node_parameters` declarations + `rlShaders.mtd` UI metadata (defaults,
  min/softmax ranges, AOV declarations; reference rlGgx.cpp:170-198,
  rlDisney.cpp:604-638, rlSkin.cpp:107-139, src/rlShaders.mtd:1-64)
  -> `ParamSpec` tables used for validation, documentation, and DCC export.

`python -m rlshaders_tpu.models.registry` prints the full parameter
reference (the role of the .mtd file + AE templates for a headless host).

Copied verbatim from rlshaders_tpu/models/registry.py: importing any
module of rlshaders_tpu imports jax, which the torch port must not need.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..scene.build import MAT_DISNEY, MAT_GGX, MAT_SKIN, MAT_STANDARD


@dataclass(frozen=True)
class ParamSpec:
    name: str
    type: str                 # RGB | FLT | VEC | BOOL | STR
    default: Any
    soft_min: float | None = None
    soft_max: float | None = None
    hard_max: float | None = None
    linkable: bool = True
    always_linear: bool = False
    doc: str = ""


@dataclass(frozen=True)
class ShaderSpec:
    name: str
    mtype: int
    maya_id: int | None
    params: tuple
    aovs: tuple = ()


def _f(name, default, lo=0.0, hi=1.0, hard=None, doc=""):
    return ParamSpec(name, "FLT", default, lo, hi, hard, doc=doc)


RLGGX = ShaderSpec(
    name="rlGgx",
    mtype=MAT_GGX,
    maya_id=0x04700001,
    params=(
        ParamSpec("KdColor", "RGB", (1.0, 1.0, 1.0)),
        _f("Kd", 0.5),
        _f("diffuseRoughness", 0.0),
        ParamSpec("KsColor", "RGB", (1.0, 1.0, 1.0)),
        _f("Ks", 0.5),
        _f("specularRoughness", 0.0),
        ParamSpec("KtColor", "RGB", (1.0, 1.0, 1.0)),
        _f("Kt", 0.0),
        _f("ior", 1.0, 0.0, 3.0, doc="ior < 1 yields TIR mirrors (rlGgx.h:139)"),
        _f("anisotropic", 0.0),
        _f("opacity", 1.0, 0.0, 1.0, 1.0),
        ParamSpec("opacity_color", "RGB", (1.0, 1.0, 1.0)),
    ),
    aovs=(
        "direct_diffuse", "direct_specular", "refraction",
        "indirect_diffuse", "indirect_specular",
    ),
)

RLDISNEY = ShaderSpec(
    name="rlDisney",
    mtype=MAT_DISNEY,
    maya_id=0x04700002,
    params=(
        ParamSpec("base_color", "RGB", (1.0, 1.0, 1.0)),
        _f("subsurface", 0.0),
        _f("metallic", 0.0),
        _f("specular", 0.0, 0.0, 1.0, 1.0),
        _f("specular_tint", 0.0),
        _f("roughness", 0.0, 0.0, 1.0, 1.0),
        _f("anisotropic", 0.0),
        _f("sheen", 0.0, 0.0, 1.0, 1.0),
        _f("sheen_tint", 0.0),
        _f("clearcoat", 0.0),
        _f("clearcoat_gloss", 0.0),
        ParamSpec("opacity", "RGB", (1.0, 1.0, 1.0)),
        _f("indirectDiffuseScale", 1.0, 0.0, 1.0, 1.0),
        _f("indirectSpecularScale", 1.0, 0.0, 1.0, 1.0),
    ),
    aovs=(
        "direct_diffuse", "direct_specular",
        "indirect_diffuse", "indirect_specular",
    ),
)

RLSKIN = ShaderSpec(
    name="rlSkin",
    mtype=MAT_SKIN,
    maya_id=0x04700003,
    params=(
        ParamSpec("sss_color", "RGB", (1.0, 1.0, 1.0), always_linear=True),
        _f("sss_weight", 1.0),
        _f("sss_dist_multiplier", 1.0, 0.0, 3.0),
        ParamSpec("sss_scatter_dist", "VEC", (1.0, 1.0, 1.0)),
        ParamSpec("sss_cavity_fadeout", "BOOL", True, linkable=False),
        ParamSpec("specular_color", "RGB", (1.0, 1.0, 1.0), always_linear=True),
        _f("specular_weight", 0.6),
        _f("specular_roughness", 0.5),
        _f("specular_ior", 1.44, 0.0, 3.0),
        ParamSpec("sheen_color", "RGB", (1.0, 1.0, 1.0), always_linear=True),
        _f("sheen_weight", 0.0),
        _f("sheen_roughness", 0.35, 0.0, 1.0, 1.0),
        _f("sheen_ior", 1.44, 0.0, 3.0),
        _f("opacity", 1.0),
        ParamSpec("opacity_color", "RGB", (1.0, 1.0, 1.0)),
    ),
    aovs=("sheen", "specular", "sss"),
)

STANDARD = ShaderSpec(
    name="standard",
    mtype=MAT_STANDARD,
    maya_id=None,
    params=(
        _f("Kd", 0.7),
        ParamSpec("Kd_color", "RGB", (1.0, 1.0, 1.0)),
        _f("diffuse_roughness", 0.0),
        _f("Ks", 0.0),
        ParamSpec("Ks_color", "RGB", (1.0, 1.0, 1.0)),
        _f("specular_roughness", 0.47),
        ParamSpec("specular_Fresnel", "BOOL", False),
        _f("Ksn", 0.0),
        _f("Kt", 0.0),
        _f("emission", 0.0),
        ParamSpec("emission_color", "RGB", (1.0, 1.0, 1.0)),
        ParamSpec("opacity", "RGB", (1.0, 1.0, 1.0)),
    ),
)

SHADERS: dict[str, ShaderSpec] = {
    s.name: s for s in (RLGGX, RLDISNEY, RLSKIN, STANDARD)
}


def validate_node(node) -> list[str]:
    """Check a parsed .ass node's parameters against its schema; returns a
    list of warnings (unknown params are allowed — Arnold ignores them too)."""
    spec = SHADERS.get(node.type)
    if spec is None:
        return [f"unknown shader type {node.type}"]
    warnings = []
    known = {p.name for p in spec.params} | {"name"} | {
        f"aov_{a}" for a in spec.aovs
    }
    for key, val in node.params.items():
        if key not in known:
            continue
        p = next((q for q in spec.params if q.name == key), None)
        if p and p.type == "FLT" and isinstance(val, (int, float)):
            if p.hard_max is not None and val > p.hard_max:
                warnings.append(f"{node.name}.{key}={val} exceeds max {p.hard_max}")
            if p.soft_min is not None and val < p.soft_min:
                warnings.append(f"{node.name}.{key}={val} below min {p.soft_min}")
    return warnings


def describe() -> str:
    lines = []
    for s in SHADERS.values():
        lines.append(f"\n{s.name}"
                     + (f"  (maya id 0x{s.maya_id:08x})" if s.maya_id else ""))
        for p in s.params:
            rng = ""
            if p.soft_min is not None:
                hi = p.hard_max if p.hard_max is not None else p.soft_max
                kind = "max" if p.hard_max is not None else "softmax"
                rng = f"  [{p.soft_min}..{hi} {kind}]"
            flags = "".join(
                f" ({f})" for f, on in (
                    ("always_linear", p.always_linear),
                    ("not linkable", not p.linkable),
                ) if on
            )
            lines.append(f"  {p.name:<22}{p.type:<5} = {p.default}{rng}{flags}")
        if s.aovs:
            lines.append(f"  AOVs: {', '.join(s.aovs)}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
