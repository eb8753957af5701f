"""The port's scene build against the JAX package's, and the port's
independence from JAX.

Tables are compared exactly (both builds run the same numpy code on the
same parsed values), except the JAX build's power-of-two padding rows,
which the port drops.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rlshaders_tpu.parallel import mesh as jmesh
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import demo as tdemo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rlshaders_tpu_torch")


def _jax_demo(skin):
    src = jmesh.DEMO_SCENE_ASS
    if not skin:
        src = src.replace('shader "mat_skin"', 'shader "mat_floor"')
    return src


def test_demo_scene_text_is_the_jax_one():
    assert tdemo.DEMO_SCENE_ASS == jmesh.DEMO_SCENE_ASS


@pytest.mark.parametrize("name", ["ass_parser.py", "b85.py"])
def test_parser_copies_are_verbatim(name):
    """The copies differ from the JAX package's files only by the note
    that says why they are copies."""
    with open(os.path.join(REPO, "rlshaders_tpu", "scene", name)) as f:
        orig = f.read()
    with open(os.path.join(PORT, "scene", name)) as f:
        copy = f.read()
    note = ("\nCopied verbatim from rlshaders_tpu/scene/%s: importing any\n"
            "module of rlshaders_tpu imports jax, which the torch port must "
            "not need.\n" % name)
    assert note in copy
    assert copy.replace(note, "") == orig


def test_build_tables_equal_jax_build(tmp_path):
    path = os.path.join(str(tmp_path), "demo.ass")
    with open(path, "w") as f:
        f.write(_jax_demo(skin=False))
    js = jbuild.build(path)
    ts = tbuild.build(path, "cpu")
    n = ts.geometry.v0.shape[0]
    assert n == 26
    for f in tbuild.Geometry._fields:
        np.testing.assert_array_equal(
            getattr(ts.geometry, f).numpy(),
            np.asarray(getattr(js.geometry, f))[:n], err_msg=f)
    # padding rows are inert: invisible and degenerate
    assert not np.asarray(js.geometry.visibility)[n:].any()
    for f in tbuild.Materials._fields:
        np.testing.assert_array_equal(
            getattr(ts.materials, f).numpy(),
            np.asarray(getattr(js.materials, f)), err_msg=f)
    for f in tbuild.QuadLights._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ts.quad_lights, f)),
            np.asarray(getattr(js.quad_lights, f)), err_msg=f)
    for f in tbuild.SkyLight._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ts.sky, f)),
                                      np.asarray(getattr(js.sky, f)))
    for f in tbuild.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ts.camera, f)),
                                      np.asarray(getattr(js.camera, f)))
    assert dataclasses.asdict(ts.options) == dataclasses.asdict(js.options)
    assert ts.mesh_names == js.mesh_names
    assert ts.material_names == js.material_names


def test_interop_round_trip():
    scene, accel = tdemo.demo_scene(skin=False)
    s2, a2 = interop.scene_from_numpy(interop.scene_tables(scene, accel),
                                      "cpu")
    for t1, t2 in ((scene.geometry, s2.geometry),
                   (scene.materials, s2.materials), (accel.tree, a2.tree),
                   (accel.tris, a2.tris)):
        for a, b in zip(t1, t2):
            assert torch.equal(a, b)
    assert s2.quad_lights.valid == scene.quad_lights.valid
    assert s2.options == scene.options


@pytest.mark.parametrize("snippet,what", [
    ('standard\n{\n name m\n Kd_color "tex"\n}\n'
     'MayaFile\n{\n name tex\n filename "x.png"\n}\n', "texture"),
    ('disk_light\n{\n name d\n radius 1\n matrix\n 1 0 0 0\n 0 1 0 0\n'
     ' 0 0 1 0\n 0 0 0 1\n}\n', "disk light"),
])
def test_unported_features_raise(snippet, what):
    src = _jax_demo(skin=False).replace('shader "mat_floor"', 'shader "m"',
                                        1) + snippet
    with pytest.raises(NotImplementedError):
        tbuild.build_text(src)


def test_unported_materials_raise_in_gather():
    from rlshaders_tpu_torch.models import dispatch

    scene, _ = tdemo.demo_scene(skin=True)
    m = scene.materials
    with pytest.raises(NotImplementedError, match="rlSkin"):
        dispatch.gather(m, torch.zeros(4, dtype=torch.int32),
                        torch.ones(4, dtype=torch.bool))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "rlshaders_tpu"), (path, mod)
    mods = sorted(
        "rlshaders_tpu_torch." + os.path.relpath(p, PORT)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in files if p.startswith(PORT))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert 'jax' not in sys.modules, 'jax imported'\n"
            + "assert not [m for m in sys.modules if m.startswith("
              "'rlshaders_tpu.') or m == 'rlshaders_tpu']\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
