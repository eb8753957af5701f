"""The port's scene build against the JAX package's, and the port's
independence from JAX.

Tables are compared exactly (both builds run the same numpy code on the
same parsed values), except the JAX build's power-of-two padding rows,
which the port drops.
"""
import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rlshaders_tpu.parallel import mesh as jmesh
from rlshaders_tpu.scene import build as jbuild
from tools import make_image_formats as fm
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import demo as tdemo
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()

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
    for f in tbuild.DiskLights._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ts.disk_lights, f)),
            np.asarray(getattr(js.disk_lights, f)), err_msg=f)
    for f in ts.textures._fields:
        np.testing.assert_array_equal(getattr(ts.textures, f).numpy(),
                                      np.asarray(getattr(js.textures, f)))
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
    scene, accel = tdemo.demo_scene(skin=False, device="cpu")
    s2, a2 = interop.scene_from_numpy(interop.scene_tables(scene, accel),
                                      "cpu")
    for t1, t2 in ((scene.geometry, s2.geometry),
                   (scene.materials, s2.materials), (accel.tree, a2.tree),
                   (accel.tris, a2.tris), (scene.textures, s2.textures)):
        for a, b in zip(t1, t2):
            assert torch.equal(a, b)
    assert s2.quad_lights.valid == scene.quad_lights.valid
    assert s2.disk_lights.valid == scene.disk_lights.valid == (False,)
    assert s2.options == scene.options


def _nested(tmp_path) -> str:
    """A directory three levels below tmp_path: the build's texture search
    (up to `../../../data`) then stays inside tmp_path."""
    d = tmp_path / "a" / "b" / "c"
    d.mkdir(parents=True)
    return str(d)


@pytest.mark.parametrize("snippet,what", [
    ('standard\n{\n name m\n Kd_color "tex"\n}\n'
     'MayaFile\n{\n name tex\n filename "x.png"\n}\n', "texture"),
    ('disk_light\n{\n name d\n radius 1\n matrix\n 1 0 0 0\n 0 1 0 0\n'
     ' 0 0 1 0\n 0 0 0 1\n}\n', "disk light"),
])
def test_unported_features_raise(snippet, what, tmp_path):
    """Texture links and disk lights raised before their slice; now they
    build as the JAX build does: a texture whose file is not found is no
    texture (id -1, silently), a disk light is a row of the disk table."""
    src = _jax_demo(skin=False).replace('shader "mat_floor"', 'shader "m"',
                                        1) + snippet
    scene = tbuild.build_text(src, device="cpu", base_dir=_nested(tmp_path))
    m = scene.materials
    if what == "texture":
        assert (m.kd_tex == -1).all() and scene.textures.data.shape == (1, 3)
    else:
        assert scene.disk_lights.valid == (True,)
        assert torch.equal(scene.disk_lights.normal[0],
                           torch.tensor([0.0, 0.0, -1.0]))


def test_still_unported_raise(tmp_path):
    """An image format the port does not decode raises (AVIF); a baseline
    JPEG, a progressive JPEG, a GIF, a TGA, an IM, a lossless WebP, an
    animated WebP (its first frame) and a JPEG 2000 build, each to the
    same texels. Trace sets build: the floor's triangles carry the set's
    bit 8, the others none."""
    from PIL import Image

    base = _nested(tmp_path)

    src = _jax_demo(skin=False)
    scene = tbuild.build_text(src.replace(' name floor\n',
                                          ' name floor\n trace_sets "a"\n',
                                          1), device="cpu")
    assert scene.trace_set_names == ["a"]
    floor = scene.mesh_names.index("floor")
    vis = scene.geometry.visibility
    on_floor = scene.geometry.mesh_id == floor
    assert on_floor.any()
    assert ((vis[on_floor] & (1 << 8)) != 0).all()
    assert ((vis[~on_floor] & ~0xFF) == 0).all()
    img = Image.fromarray(np.full((4, 4, 3), 200, np.uint8))
    for name, kw in (("t.jpg", {}), ("p.jpg", {"progressive": True}),
                     ("t.gif", {}), ("t.tga", {}), ("t.im", {}),
                     ("t.jp2", {}), ("s.webp", {"lossless": True}),
                     ("t.webp", {"save_all": True, "lossless": True,
                                 "append_images": [Image.fromarray(
                                     np.full((4, 4, 3), 9, np.uint8))]}),
                     ("t.avif", {})):
        img.save(os.path.join(base, name), **kw)
    src = (src.replace('shader "mat_floor"', 'shader "m"', 1)
           + 'standard\n{\n name m\n Kd_color "tex"\n}\n'
           'MayaFile\n{\n name tex\n filename "%s"\n}\n')
    scene = tbuild.build_text(src % "t.jpg", device="cpu", base_dir=base)
    assert scene.textures.data.shape == (16 + 4 + 1, 3)
    for name in ("p.jpg", "t.gif"):
        other = tbuild.build_text(src % name, device="cpu", base_dir=base)
        assert torch.equal(other.textures.data, scene.textures.data), name
    for name in ("t.tga", "t.im", "s.webp", "t.webp", "t.jp2"):
        other = tbuild.build_text(src % name, device="cpu", base_dir=base)
        assert torch.equal(other.textures.data,
                           torch.full((21, 3), 200 / 255)), name
    # an AVIF (lossy YUV) builds to the texels of PIL's decode of it, as a
    # PNG of that decode does; a PSD and a Sun raster (refused before their
    # slices) to their pixels; an EPS, which PIL opens and cannot load
    # without Ghostscript, raises NotImplementedError naming it
    Image.open(os.path.join(base, "t.avif")).convert("RGB").save(
        os.path.join(base, "avif.png"))
    other = tbuild.build_text(src % "t.avif", device="cpu", base_dir=base)
    png = tbuild.build_text(src % "avif.png", device="cpu", base_dir=base)
    assert torch.equal(other.textures.data, png.textures.data)
    with open(os.path.join(base, "t.psd"), "wb") as f:
        f.write(fm.psd_bytes(np.full((3, 4, 4), 200), 3, rle=True))
    other = tbuild.build_text(src % "t.psd", device="cpu", base_dir=base)
    assert torch.equal(other.textures.data, torch.full((21, 3), 200 / 255))
    with open(os.path.join(base, "t.ras"), "wb") as f:
        f.write(fm.sun_raster(np.full((4, 4, 3), 200, np.uint8)))
    assert Image.open(os.path.join(base, "t.ras")).format == "SUN"
    other = tbuild.build_text(src % "t.ras", device="cpu", base_dir=base)
    assert torch.equal(other.textures.data, torch.full((21, 3), 200 / 255))
    Image.new("RGB", (4, 4), (200, 200, 200)).save(os.path.join(base,
                                                               "t.eps"))
    assert Image.open(os.path.join(base, "t.eps")).format == "EPS"
    with pytest.raises(NotImplementedError, match="EPS"):
        tbuild.build_text(src % "t.eps", device="cpu", base_dir=base)


@pytest.mark.parametrize("where", ["suite/data", "nowhere"])
def test_textures_are_found_in_the_testsuite_layout(tmp_path, where,
                                                    monkeypatch):
    """A scene at suite/mtoa/0001/data/scene.ass whose texture lies only in
    suite/data (the testsuite's layout, which `cli test` renders): the
    port's build finds the file the JAX build finds, by the same path,
    to the same texture table; with the file nowhere both give -1."""
    case = tmp_path / "suite" / "mtoa" / "0001" / "data"
    case.mkdir(parents=True)
    (tmp_path / "suite" / "data").mkdir()
    if where != "nowhere":
        with open(os.path.join(REPO, "scenes", "data", "grid.png"),
                  "rb") as f:
            (tmp_path / where / "grid.png").write_bytes(f.read())
    src = (_jax_demo(skin=False).replace('shader "mat_floor"', 'shader "m"',
                                         1)
           + 'standard\n{\n name m\n Kd_color "tex"\n}\n'
           'MayaFile\n{\n name tex\n filename "grid.png"\n}\n')
    path = case / "scene.ass"
    path.write_text(src)
    read = {"jax": [], "port": []}
    for mod, key in ((jbuild, "jax"), (tbuild, "port")):
        def load(p, *args, _load=mod.load_image, _key=key):
            read[_key].append(p)
            return _load(p, *args)
        monkeypatch.setattr(mod, "load_image", load)
    js = jbuild.build(str(path))
    ts = tbuild.build(str(path), device="cpu")
    assert read["port"] == read["jax"] == (
        [] if where == "nowhere" else [str(tmp_path / where / "grid.png")])
    kd = ts.materials.kd_tex.numpy()
    assert np.array_equal(np.asarray(js.materials.kd_tex)[:len(kd)], kd)
    assert (kd.max() == -1) == (where == "nowhere")
    for f in ts.textures._fields:
        assert np.array_equal(np.asarray(getattr(js.textures, f)),
                              getattr(ts.textures, f).numpy()), f


def test_unported_materials_raise_in_gather():
    """rlSkin and rlDisney gather (nothing raises there any more), and a
    texture link on rlDisney's base_color builds into its kd_tex column."""
    from rlshaders_tpu_torch.models import dispatch

    scene, _ = tdemo.demo_scene(skin=True, device="cpu")
    m = scene.materials
    ids = torch.arange(3, dtype=torch.int32)
    ent = torch.ones(3, dtype=torch.bool)
    g = dispatch.gather(m, ids, ent, has_skin=True, has_disney=False)
    assert g.dsy is None
    disney = m._replace(mtype=torch.where(m.mtype == tbuild.MAT_SKIN,
                                          tbuild.MAT_DISNEY, m.mtype))
    g = dispatch.gather(disney, ids, ent, has_skin=False, has_disney=True)
    is_disney = g.mtype == tbuild.MAT_DISNEY
    assert bool(is_disney.any()) and g.ggx2 is None
    assert bool((g.has_diffuse & g.has_spec)[is_disney].all())
    assert g.dsy.alpha_x.shape == (3,)
    src = (_jax_demo(skin=False).replace('shader "mat_floor"', 'shader "d"',
                                         1)
           + 'rlDisney\n{\n name d\n base_color "tex"\n}\n'
           'MayaFile\n{\n name tex\n filename "data/grid.png"\n}\n')
    scene = tbuild.build_text(src, device="cpu",
                              base_dir=os.path.join(REPO, "scenes"))
    d = scene.material_names.index("d")
    assert int(scene.materials.mtype[d]) == tbuild.MAT_DISNEY
    assert int(scene.materials.kd_tex[d]) == 0
    assert scene.textures.sizes[0, 0].tolist() == [256, 256]


def test_cpu_entry_points_settle_the_vector_math():
    """In a fresh process, importing the port settles nothing; each CPU
    entry point (demo_scene, build_text and so build, scene_from_numpy)
    settles the vector math before its arithmetic, and after it torch.sqrt
    of 65,536 ones (a call split over every thread) is exactly 1.
    tools/cpu_first_call.py measures the unsettled failure rate."""
    code = ("import torch\n"
            "from rlshaders_tpu_torch import interop\n"
            "from rlshaders_tpu_torch.core import cpu_math\n"
            "from rlshaders_tpu_torch.scene import build, demo\n"
            "assert not cpu_math._settled\n"
            "scene, accel = demo.demo_scene(skin=False, device='cpu')\n"
            "assert cpu_math._settled\n"
            "y = torch.sqrt(torch.ones(1 << 16))\n"
            "assert bool((y == 1).all()), float(y.min())\n"
            "tables = interop.scene_tables(scene, accel)\n"
            "cpu_math._settled = False\n"
            "build.build_text(demo.DEMO_SCENE_ASS, device='cpu')\n"
            "assert cpu_math._settled\n"
            "cpu_math._settled = False\n"
            "interop.scene_from_numpy(tables, 'cpu')\n"
            "assert cpu_math._settled\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card():
    """build, build_text and demo_scene put the scene on the card unless
    asked for the CPU; render runs where the scene lives."""
    from rlshaders_tpu_torch.integrator import wavefront as twave

    for fn in (tbuild.build, tbuild.build_text, tdemo.demo_scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(twave.render).parameters
    if torch.cuda.is_available():
        assert tdemo.demo_scene(skin=False)[0].device.type == "cuda"
    else:
        # no fallback: torch's own error
        with pytest.raises((AssertionError, RuntimeError)):
            tdemo.demo_scene(skin=False)
    scene, accel = tdemo.demo_scene(skin=False, device="cpu")
    out = twave.render(scene, accel, aa_samples=1, xres=4, yres=4)
    assert all(v.device.type == "cpu" for k, v in out.items()
               if k != "__stats__")
    meta = accel._replace(
        tree=accel.tree._replace(bbox_min=accel.tree.bbox_min.to("meta")))
    with pytest.raises(ValueError, match="accel is on meta"):
        twave.render(scene, meta, aa_samples=1, xres=4, yres=4)


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
    files.append(os.path.join(REPO, "tools", "make_dense_disney.py"))
    files.append(os.path.join(REPO, "tools", "make_image_modes.py"))
    files.append(os.path.join(REPO, "tools", "make_image_formats.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "rlshaders_tpu"), (path, mod)
    mods = sorted(
        "rlshaders_tpu_torch." + os.path.relpath(p, PORT)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in files if p.startswith(PORT))
    assert {"rlshaders_tpu_torch.accel.native",
            "rlshaders_tpu_torch.cli", "rlshaders_tpu_torch.io.exr",
            "rlshaders_tpu_torch.io.png", "rlshaders_tpu_torch.models.dcc",
            "rlshaders_tpu_torch.models.registry",
            "rlshaders_tpu_torch.parallel.mesh",
            "rlshaders_tpu_torch.scene.bmp", "rlshaders_tpu_torch.scene.bomb",
            "rlshaders_tpu_torch.scene.gif",
            "rlshaders_tpu_torch.scene.jpeg", "rlshaders_tpu_torch.scene.lzw",
            "rlshaders_tpu_torch.scene.png", "rlshaders_tpu_torch.scene.tiff",
            "rlshaders_tpu_torch.utils.sample_writer",
            "rlshaders_tpu_torch.utils.watermark"} <= set(mods)
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert 'jax' not in sys.modules, 'jax imported'\n"
            + "assert 'PIL' not in sys.modules, 'PIL imported'\n"
            + "assert not [m for m in sys.modules if m.startswith("
              "'rlshaders_tpu.') or m == 'rlshaders_tpu']\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_never_imports_pil():
    """No module of the port imports PIL (the card's machine has none),
    and decoding a file of every format of scenes/data/formats_b, with
    PIL's import barred, imports none either."""
    for d, _, names in os.walk(PORT):
        for n in names:
            if n.endswith(".py"):
                for mod in _imports(os.path.join(d, n)):
                    assert mod.split(".")[0] != "PIL", (n, mod)
    code = (
        "import os, sys\n"
        "class Bar:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'PIL':\n"
        "            raise ImportError('PIL is barred')\n"
        "sys.meta_path.insert(0, Bar())\n"
        "from rlshaders_tpu_torch.scene.texture import decode_image\n"
        "d = 'scenes/data/formats_b'\n"
        "for n in sorted(os.listdir(d)):\n"
        "    if not n.startswith('texture_2048'):\n"
        "        decode_image(open(os.path.join(d, n), 'rb').read())\n"
        "assert 'PIL' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
