"""DCC integration exports: Arnold .mtd metadata + Maya AE templates.

The reference ships hand-written UI metadata (src/rlShaders.mtd:1-64) and
three Attribute Editor templates (scripts/ae/rl*Template.py) that Maya/MtoA
load alongside the plugin. Here both artifacts are GENERATED from the single
declarative source of truth — the `models.registry` ParamSpec tables — so
the shader schema can never drift from its DCC metadata.

`python -m rlshaders_tpu.cli dcc --outdir <dir>` writes:
  rlShaders.mtd                    node blocks with maya.name/classification/
                                   id + per-attr min/softmax/max ranges
  ae/rl<Node>Template.py           pymel AE templates (layout sections from
                                   the UI_LAYOUTS table below, AOV reorder
                                   from the registry's aov list)

Copied verbatim from rlshaders_tpu/models/dcc.py: importing any
module of rlshaders_tpu imports jax, which the torch port must not need.
"""
from __future__ import annotations

import os

from .registry import SHADERS, ShaderSpec

# Attribute-editor layout: (section title, collapsed, ((attr, label), ...)).
# Attrs not listed fall through to the AE's "extra controls" section, same
# as the reference templates rely on addExtraControls().
UI_LAYOUTS: dict[str, tuple] = {
    "rlGgx": (
        ("Diffuse", False, (("KdColor", "Color"), ("Kd", "Weight"),
                            ("diffuseRoughness", "Roughness"))),
        ("Specular", False, (("KsColor", "Color"), ("Ks", "Weight"),
                             ("specularRoughness", "Roughness"),
                             ("anisotropic", None), ("ior", "IOR"))),
        ("Refract", False, (("KtColor", "Color"), ("Kt", "Weight"))),
        ("Opacity", True, (("opacity", "Weight"),
                           ("opacity_color", "Color"))),
    ),
    "rlDisney": (
        ("Base", False, (("base_color", "Color"), ("metallic", None),
                         ("roughness", None), ("subsurface", None))),
        ("Specular", False, (("specular", "Weight"),
                             ("specular_tint", "Tint"),
                             ("anisotropic", None))),
        ("Sheen", True, (("sheen", "Weight"), ("sheen_tint", "Tint"))),
        ("Clearcoat", True, (("clearcoat", "Weight"),
                             ("clearcoat_gloss", "Gloss"))),
        ("Indirect", True, (("indirectDiffuseScale", "Diffuse Scale"),
                            ("indirectSpecularScale", "Specular Scale"))),
        ("Opacity", True, (("opacity", "Weight"),)),
    ),
    "rlSkin": (
        ("Sheen", False, (("sheen_color", "Color"),
                          ("sheen_weight", "Weight"),
                          ("sheen_roughness", "Roughness"),
                          ("sheen_ior", "IOR"))),
        ("Specular", False, (("specular_color", "Color"),
                             ("specular_weight", "Weight"),
                             ("specular_roughness", "Roughness"),
                             ("specular_ior", "IOR"))),
        ("SSS", False, (("sss_color", "Color"), ("sss_weight", "Weight"),
                        ("sss_dist_multiplier", "Distance Multiplier"),
                        ("sss_scatter_dist", "Scatter Distance"),
                        ("sss_cavity_fadeout",
                         "Cavity Affects Diffusion"))),
        ("Opacity", True, (("opacity", "Weight"),
                           ("opacity_color", "Color"))),
    ),
}


def _mtd_node(spec: ShaderSpec) -> str:
    lines = [f"[node {spec.name}]"]
    lines.append('    desc                    STRING      ""')
    lines.append(f'    maya.name               STRING      "{spec.name}"')
    lines.append('    maya.classification     STRING      "shader/surface"')
    lines.append(f"    maya.id                 INT         0x{spec.maya_id:08x}")
    lines.append("")
    for p in spec.params:
        rows = []
        if p.type == "FLT":
            if p.soft_min is not None:
                rows.append(("min", p.soft_min))
            if p.hard_max is not None:
                rows.append(("max", p.hard_max))
            elif p.soft_max is not None:
                rows.append(("softmax", p.soft_max))
        if not p.linkable:
            rows.append(("linkable", False))
        if p.always_linear:
            rows.append(("always_linear", True))
        if not rows:
            continue
        lines.append(f"    [attr {p.name}]")
        for key, val in rows:
            if isinstance(val, bool):
                lines.append(f"        {key:<19} BOOL    {str(val).lower()}")
            else:
                lines.append(f"        {key:<19} FLOAT   {float(val):.1f}")
    return "\n".join(lines)


def generate_mtd() -> str:
    """The rlShaders.mtd body for the three plugin nodes (`standard` is an
    Arnold built-in — it carries no plugin metadata, as in the reference)."""
    blocks = [
        _mtd_node(s) for s in SHADERS.values() if s.maya_id is not None
    ]
    return "\n\n".join(blocks) + "\n"


def generate_ae_template(spec: ShaderSpec) -> str:
    layout = UI_LAYOUTS.get(spec.name, ())
    body = []
    for title, collapse, attrs in layout:
        body.append(f'        self.beginLayout("{title}", '
                    f"collapse={collapse})")
        for attr, label in attrs:
            if label:
                body.append(
                    f'        self.addControl("{attr}", label="{label}")')
            else:
                body.append(f'        self.addControl("{attr}")')
        body.append("        self.endLayout()")
        body.append("")
    aov = ""
    if spec.aovs:
        names = ", ".join(f'"{a}"' for a in spec.aovs)
        aov = f"        self.addAOVLayout(aovReorder=[{names}])\n"
    inner = "\n".join(body)
    return f'''"""Maya Attribute Editor template for {spec.name}.

Generated from rlshaders_tpu.models.registry by models/dcc.py — do not edit
by hand (counterpart of the reference's scripts/ae/{spec.name}Template.py).
"""
import pymel.core as pm
from mtoa.ui.ae.shaderTemplate import ShaderAETemplate


class AE{spec.name}Template(ShaderAETemplate):

    def setup(self):
        self.addSwatch()
        self.beginScrollLayout()

{inner}        self.addBumpLayout()
{aov}
        pm.mel.AEdependNodeTemplate(self.nodeName)

        self.addExtraControls()
        self.endScrollLayout()
'''


def export(outdir: str) -> list[str]:
    """Write rlShaders.mtd + ae/ templates under outdir; returns the paths."""
    os.makedirs(os.path.join(outdir, "ae"), exist_ok=True)
    written = []
    mtd = os.path.join(outdir, "rlShaders.mtd")
    with open(mtd, "w") as f:
        f.write(generate_mtd())
    written.append(mtd)
    for spec in SHADERS.values():
        if spec.maya_id is None:
            continue
        path = os.path.join(outdir, "ae", f"{spec.name}Template.py")
        with open(path, "w") as f:
            f.write(generate_ae_template(spec))
        written.append(path)
    return written
