"""The port's textures against the JAX package: every function of
scene/texture.py, the PNG decoder, the texture links of the build, the
texture lookups of dispatch.gather, apply_bump and the ray-cone footprint
of the wavefront's _surface; inputs made with numpy from a seed.

Tolerances, as measured on these inputs:

* Texel tables, level sizes and offsets, the decoded images and the
  material columns: equal.
* Filter weights, lookups and levels of detail: RTOL 2e-5 / ATOL 2e-6 (the
  other elementwise modules' tolerance). Measured: the lookups equal, the
  levels within 4.8e-7 (log2 rounds differently).
* A continuous level of detail whose floor falls on the other side of an
  integer in the two packages picks other mip levels, and bump's finite
  differences divide a height difference by a step of 5e-3 or more; so
  gather and apply_bump hold 99% of the values to RTOL/ATOL and every
  value to LOOSE 1e-3 relative / 1e-4 absolute. Measured: gather every
  value within RTOL/ATOL; apply_bump with every footprint under its 5e-3
  floor 3 of 12,288 values outside it, by up to 6.2e-5.
"""
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.core import vec3 as jv
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.models import dispatch as jdispatch
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.scene import texture as jtex
from test_r5_semantics import SCENE_INVERT
from tools import make_image_formats as fm
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.core import vec3 as tv
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.models import dispatch as tdispatch
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import texture as ttex

cpu_math.settle()

N = 4096
RTOL = 2e-5
ATOL = 2e-6
LOOSE_RTOL = 1e-3
LOOSE_ATOL = 1e-4
TIGHT_SHARE = 0.99
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "textured_disk.ass")
IMAGES = [os.path.join(REPO, "scenes", "data", f)
          for f in sorted(os.listdir(os.path.join(REPO, "scenes", "data")))
          if f.endswith((".png", ".jpg"))]


def _np(x):
    if isinstance(x, tv.V3):
        return x.aos().numpy()
    if isinstance(x, jv.V3):
        return np.asarray(x.aos())
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)


def close_mostly(t, j):
    a, b = _np(t), _np(j)
    np.testing.assert_allclose(a, b, rtol=LOOSE_RTOL, atol=LOOSE_ATOL)
    tight = np.abs(a - b) <= ATOL + RTOL * np.abs(b)
    assert tight.mean() >= TIGHT_SHARE, tight.mean()


# ---------------------------------------------------------------------------
# texture.py
# ---------------------------------------------------------------------------

def _images():
    """Three storage-space images: odd sizes (the odd rows and columns of
    _downsample2, a clamped tail) and a 1x1."""
    rs = np.random.default_rng(5)
    return [rs.random((37, 23, 3)).astype(np.float32),
            rs.random((64, 48, 3)).astype(np.float32),
            rs.random((1, 1, 3)).astype(np.float32)]


@pytest.fixture(scope="module")
def stacks():
    ims = _images()
    return jtex.TextureStack.build(ims), ttex.TextureStack.build(ims, "cpu")


def _lanes(seed):
    rs = np.random.default_rng(seed)
    tid = rs.integers(-1, 3, N).astype(np.int32)
    uv = rs.uniform(-2.5, 3.5, (N, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 4) / 4   # texel edges and exact wraps
    # up to the last table level: past a texture's real levels, its tail
    lod = rs.uniform(0.0, 11.99, N).astype(np.float32)
    lod[:256] = 0.0
    lod[256:512] = np.floor(lod[256:512])
    fp = np.exp(rs.uniform(-12, 1, N)).astype(np.float32)
    return tid, uv, lod, fp


def test_stack_tables_equal(stacks):
    js, ts = stacks
    for f in ts._fields:
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy()), f
    # the 37x23 texture: 7 real levels (37x23, 19x12, 10x6, 5x3, 3x2, 2x1,
    # 1x1), the tail repeating the last
    assert ts.n_levels.tolist() == [7, 7, 1]
    assert ts.sizes[0, 1].tolist() == [19, 12]
    assert ts.sizes[0, 6].tolist() == ts.sizes[0, 11].tolist() == [1, 1]
    empty_j, empty_t = jtex.TextureStack.build([]), ttex.TextureStack.build(
        [], "cpu")
    for f in ts._fields:
        assert np.array_equal(np.asarray(getattr(empty_j, f)),
                              getattr(empty_t, f).numpy()), f


@pytest.mark.parametrize("shape", [(37, 23), (6, 5), (1, 7), (2, 2)])
def test_downsample2(shape):
    im = np.random.default_rng(1).random(shape + (3,)).astype(np.float32)
    assert np.array_equal(ttex._downsample2(im), jtex._downsample2(im))


def test_cubic_weights():
    t = np.random.default_rng(2).random(N).astype(np.float32)
    t[:4] = [0.0, 0.5, 1.0 - 2 ** -24, 0.25]
    for a, b in zip(ttex._cubic_weights(torch.tensor(t)),
                    jtex._cubic_weights(jnp.asarray(t))):
        close(a, b)


def test_fetch_wraps(stacks):
    js, ts = stacks
    tid, uv, lod, _ = _lanes(3)
    tid = np.maximum(tid, 0)
    lvl = np.minimum(lod.astype(np.int32), 11)
    rs = np.random.default_rng(4)
    y = rs.integers(-300, 300, N).astype(np.int32)
    x = rs.integers(-300, 300, N).astype(np.int32)
    a = ttex._fetch(ts, torch.tensor(tid).long(), torch.tensor(lvl).long(),
                    torch.tensor(y), torch.tensor(x))
    b = jtex._fetch(js, jnp.asarray(tid), jnp.asarray(lvl), jnp.asarray(y),
                    jnp.asarray(x))
    assert np.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("fn", ["_level_uv", "_bicubic_level",
                                "_bilinear_level"])
def test_level_functions(stacks, fn):
    js, ts = stacks
    tid, uv, lod, _ = _lanes(6)
    tid = np.maximum(tid, 0)
    lvl = np.minimum(lod.astype(np.int32), 11)
    a = getattr(ttex, fn)(ts, torch.tensor(tid).long(),
                          torch.tensor(lvl).long(), torch.tensor(uv))
    b = getattr(jtex, fn)(js, jnp.asarray(tid), jnp.asarray(lvl),
                          jnp.asarray(uv))
    for x, y in zip(a, b) if fn == "_level_uv" else [(a, b)]:
        close(x, y)


def test_compute_lod(stacks):
    js, ts = stacks
    tid, _, _, fp = _lanes(7)
    for bias in (0.0, -0.5):
        close(ttex.compute_lod(ts, torch.tensor(tid), torch.tensor(fp), bias),
              jtex.compute_lod(js, jnp.asarray(tid), jnp.asarray(fp), bias))


@pytest.mark.parametrize("fn,with_lod", [
    ("sample_smart_bicubic", True), ("sample_smart_bicubic", False),
    ("sample_bicubic", False), ("sample_bilinear", True),
    ("sample_bilinear", False)])
def test_samplers(stacks, fn, with_lod):
    """tex_id -1 (ones), uv below 0 and above 1, levels 0, integer,
    fractional and past a texture's top level (its clamped tail)."""
    js, ts = stacks
    tid, uv, lod, _ = _lanes(8)
    args_t = [torch.tensor(tid), torch.tensor(uv)]
    args_j = [jnp.asarray(tid), jnp.asarray(uv)]
    if with_lod:
        args_t.append(torch.tensor(lod))
        args_j.append(jnp.asarray(lod))
    a = getattr(ttex, fn)(ts, *args_t)
    close(a, getattr(jtex, fn)(js, *args_j))
    assert (_np(a)[tid < 0] == 1.0).all()


# ---------------------------------------------------------------------------
# the PNG decoder
# ---------------------------------------------------------------------------

def _png(px, filters, color):
    """An 8-bit PNG of px (H, W, C) with row y filtered by filters[y % n]
    (an encoder independent of the one in tools/)."""
    h, w, c = px.shape
    raw = bytearray()
    prev = [0] * (w * c)
    for y in range(h):
        cur = px[y].reshape(-1).tolist()
        ft = filters[y % len(filters)]
        raw.append(ft)
        for i, v in enumerate(cur):
            a = cur[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            if ft == 0:
                p = 0
            elif ft == 1:
                p = a
            elif ft == 2:
                p = b
            elif ft == 3:
                p = (a + b) // 2
            else:
                q = a + b - cc
                pa, pb, pc = abs(q - a), abs(q - b), abs(q - cc)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            raw.append((v - p) & 0xFF)
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("path", IMAGES, ids=os.path.basename)
def test_committed_images_decode_as_pil(path):
    decode = ttex.decode_jpeg if path.endswith(".jpg") else ttex.decode_png
    with open(path, "rb") as f:
        mine = decode(f.read())
    assert np.array_equal(mine, np.asarray(Image.open(path).convert("RGB")))
    assert np.array_equal(ttex.load_image(path),
                          jtex.load_image(path, 1.0))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_filters(tmp_path, filt, channels):
    px = np.random.default_rng(9).integers(0, 256, (7, 11, channels),
                                           dtype=np.uint8)
    px[3] = 255  # a flat row: the filters' wrap-around
    filters = [0, 1, 2, 3, 4] if filt == "mixed" else [filt]
    path = tmp_path / "t.png"
    path.write_bytes(_png(px, filters, {3: 2, 4: 6}[channels]))
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(ttex.decode_png(path.read_bytes()), want)
    assert np.array_equal(want, px[..., :3])


def test_other_formats_raise(tmp_path):
    """A GIF, a grey PNG, a TGA, an IM, a WebP, an animated WebP, a JPEG
    2000, an AVIF, a PSD and a Sun raster, refused before their slices,
    now decode as PIL does; an EPS, which PIL opens and cannot load
    without Ghostscript, raises NotImplementedError naming its format."""
    img = Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (4, 4, 3), dtype=np.uint8))
    for name, save in (("x.gif", img), ("g.png", img.convert("L")),
                       ("x.tga", img), ("x.im", img), ("x.webp", img)):
        save.save(tmp_path / name)
        assert np.array_equal(ttex.load_image(str(tmp_path / name)),
                              jtex.load_image(str(tmp_path / name), 1.0))
    for name, fmt, kw in (
            ("a.webp", "WEBP", {
                "save_all": True,
                "append_images": [img.transpose(Image.Transpose.ROTATE_90)]}),
            ("x.jp2", "JPEG2000", {})):
        img.save(tmp_path / name, fmt, **kw)
        assert Image.open(tmp_path / name).format == fmt
        assert np.array_equal(ttex.load_image(str(tmp_path / name)),
                              jtex.load_image(str(tmp_path / name), 1.0))
    img.save(tmp_path / "x.avif", "AVIF")
    assert Image.open(tmp_path / "x.avif").format == "AVIF"
    assert np.array_equal(ttex.load_image(str(tmp_path / "x.avif")),
                          jtex.load_image(str(tmp_path / "x.avif"), 1.0))
    (tmp_path / "x.psd").write_bytes(fm.psd_bytes(
        np.moveaxis(np.asarray(img), -1, 0), 3, rle=True, layers=True))
    assert Image.open(tmp_path / "x.psd").format == "PSD"
    assert np.array_equal(ttex.load_image(str(tmp_path / "x.psd")),
                          jtex.load_image(str(tmp_path / "x.psd"), 1.0))
    (tmp_path / "x.ras").write_bytes(fm.sun_raster(np.asarray(img)))
    assert Image.open(tmp_path / "x.ras").format == "SUN"
    assert np.array_equal(ttex.load_image(str(tmp_path / "x.ras")),
                          jtex.load_image(str(tmp_path / "x.ras"), 1.0))
    img.save(tmp_path / "x.eps")
    assert Image.open(tmp_path / "x.eps").format == "EPS"
    with pytest.raises(NotImplementedError, match="EPS"):
        ttex.load_image(str(tmp_path / "x.eps"))


# ---------------------------------------------------------------------------
# the build's texture links
# ---------------------------------------------------------------------------

PLANE = """options
{
 AA_samples 1
 xres 8
 yres 8
 texture_gamma %(tg)s
 shader_gamma 2.2
}
persp_camera
{
 name cam
 fov 40
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 4 1
}
polymesh
{
 name plane
 nsides 1 1 UINT
4
 vidxs 4 1 UINT
0 1 2 3
 vlist 4 1 POINT
-1 -1 0 1 -1 0 1 1 0 -1 1 0
 uvidxs 4 1 UINT
0 1 2 3
 uvlist 4 1 POINT2
0 0 1 0 1 1 0 1
 shader "%(shader)s"
}
"""

NODES = """MayaFile
{
 name f_plain
 filename "data/grid.png"
}
MayaFile
{
 name f_bal
 filename "data/logo.png"
 colorGain 0.5 0.7 0.9
 colorOffset 0.1 0.2 0.3
 invert on
}
MayaFile
{
 name f_missing
 filename "data/nowhere.png"
}
MayaProjection
{
 name p_off
 image "f_bal"
 wrap off
 defaultColor 0.2 0.4 0.6
 colorGain 2 2 2
 colorOffset 0.01 0.02 0.03
 placementMatrix 0.5 0 0 0 0 0.5 0 0 0 0 1 0 0.1 0.2 0 1
}
MayaProjection
{
 name p_on
 image "f_plain"
 placementMatrix 2 0 0 0 0 2 0 0 0 0 1 0 0 0 0 1
}
MayaShadingEngine
{
 name se
 beauty "b3"
}
bump3d
{
 name b3
 shader "s_ks"
 bump_map "p_on.a"
 bump_height 0.2
}
standard
{
 name s_ks
 Kd_color "p_off"
 Ks "f_plain.a"
 Ksn "f_plain.a"
 Ks_color "f_plain"
}
standard
{
 name s_plain
 Kd_color "f_missing"
 Ks 0.3
}
rlGgx
{
 name g_tex
 KdColor "p_on"
}
rlDisney
{
 name d_tex
 base_color "f_plain"
}
bump3d
{
 name b_file
 shader "g_tex"
 bump_map "f_bal"
 bump_height 0.1
}
"""


@pytest.mark.parametrize("shader", ["se", "s_plain", "g_tex", "d_tex",
                                    "b_file"])
@pytest.mark.parametrize("tg", ["1", "2.2"])
def test_texture_links_build_as_jax(tmp_path, shader, tg):
    """Each link variant: MayaFile with gain, offset and invert, a missing
    file (id -1), projections with wrap off (defaultColor through the
    texture gamma) and on, chained gains, a linked Ks (read as 0) and Ksn,
    bump3d through a shading engine and on a file, texture links on rlGgx
    and rlDisney."""
    base = tmp_path / "a" / "b" / "c"      # the search stays in tmp_path
    (base / "data").mkdir(parents=True)
    for f in ("grid.png", "logo.png"):
        (base / "data" / f).write_bytes(
            open(os.path.join(REPO, "scenes", "data", f), "rb").read())
    path = base / "s.ass"
    path.write_text(PLANE % {"tg": tg, "shader": shader} + NODES)
    js = jbuild.build(str(path))
    ts = tbuild.build(str(path), device="cpu")
    for f in tbuild.Materials._fields:
        a = np.asarray(getattr(js.materials, f))
        b = getattr(ts.materials, f).numpy()
        assert np.array_equal(a.astype(b.dtype), b), f
    for f in ts.textures._fields:
        assert np.array_equal(np.asarray(getattr(js.textures, f)),
                              getattr(ts.textures, f).numpy()), f


def test_textured_scene_tables_equal():
    js = jbuild.build(SCENE)
    ts = tbuild.build(SCENE, device="cpu")
    n = ts.geometry.v0.shape[0]
    assert 1000 <= n <= 2500
    for f in tbuild.Materials._fields:
        a = np.asarray(getattr(js.materials, f))
        assert np.array_equal(a.astype(np.float64),
                              getattr(ts.materials, f).numpy()), f
    for f in ts.textures._fields:
        assert np.array_equal(np.asarray(getattr(js.textures, f)),
                              getattr(ts.textures, f).numpy()), f
    m = ts.materials
    assert (m.kd_tex >= 0).sum() == 6 and (m.bump_tex >= 0).sum() == 1
    assert sorted(m.kd_proj.tolist()) == [0, 0, 0, 0, 0, 1, 2]
    assert bool(m.kd_tex_invs.any())
    # a linked Ks reads as Ks 0 with no texture
    logo = ts.material_names.index("logo_mat")
    assert float(m.ks[logo]) == 0.0 and int(m.ks_tex[logo]) == -1


# ---------------------------------------------------------------------------
# dispatch: gather with textures, apply_bump
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    js = jbuild.build(SCENE)
    ja = jtrace.build(js.geometry)
    ts, _ = interop.scene_from_numpy(interop.scene_tables(js, ja), "cpu")
    return js, ts


def _hits(seed, n_mat):
    rs = np.random.default_rng(seed)
    mat = rs.integers(0, n_mat, N).astype(np.int32)
    uv = rs.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    p = rs.uniform(-4, 4, (N, 3)).astype(np.float32)
    fp = np.exp(rs.uniform(-9, 0, N)).astype(np.float32)
    fp_uv = (fp * rs.uniform(0.05, 3, N)).astype(np.float32)
    ent = rs.random(N) < 0.7
    ns = rs.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    return mat, uv, p, fp, fp_uv, ent, ns


def _with_ks_texture(mats, lib):
    """The table with a Ks texture on every row: the JAX build never makes
    one (a linked Ks reads as 0), but gather reads the columns."""
    n = mats.ks.shape[0]
    tex = lib.asarray(np.arange(n) % 2, dtype=lib.int32)
    proj = lib.asarray(np.arange(n) % 3, dtype=lib.int32)
    pm = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pm[:, 0, 0] = pm[:, 1, 1] = 0.7
    pm[:, 3, :2] = 0.2
    return mats._replace(ks_tex=tex, ks_proj=proj, ks=mats.ks + 0.5,
                         ks_proj_inv=lib.asarray(pm))


@pytest.mark.parametrize("ks_tex", [False, True])
@pytest.mark.parametrize("diffuse_ray", [False, True])
def test_gather_with_textures(scenes, ks_tex, diffuse_ray):
    js, ts = scenes
    jm, tm = js.materials, ts.materials
    if ks_tex:
        jm = _with_ks_texture(jm, jnp)
        tm = _with_ks_texture(tm, torch)
    mat, uv, p, fp, fp_uv, ent, _ = _hits(10, int(tm.mtype.shape[0]))
    for gamma in (1.0, 2.2):
        a = tdispatch.gather(
            tm, torch.tensor(mat), torch.tensor(ent), has_skin=False,
            has_disney=True, diffuse_ray=diffuse_ray,
            tex=tdispatch.TexLookup(ts.textures, torch.tensor(uv),
                                    tv.v3(torch.tensor(p)),
                                    torch.tensor(fp), torch.tensor(fp_uv),
                                    -0.5, gamma))
        b = jdispatch.gather(jm, js.textures, jnp.asarray(mat),
                             jnp.asarray(uv), jnp.asarray(ent),
                             jnp.asarray(p), fp=jnp.asarray(fp),
                             fp_uv=jnp.asarray(fp_uv), lod_bias=-0.5,
                             tex_gamma=gamma, diffuse_ray=diffuse_ray)
        for f in ("diffuse_color", "spec_weight"):
            close_mostly(getattr(a, f), getattr(b, f))
        close_mostly(a.dsy.base_color, b.dsy.base_color)
        for f in ("has_diffuse", "has_spec"):
            assert np.array_equal(_np(getattr(a, f)), _np(getattr(b, f)))


def test_gather_without_textures_skips_them(scenes):
    """tex=None equals the lookups on a table whose links are all -1."""
    _, ts = scenes
    m = ts.materials
    none = m._replace(kd_tex=torch.full_like(m.kd_tex, -1),
                      kd_proj=torch.zeros_like(m.kd_proj))
    mat, uv, p, fp, fp_uv, ent, _ = _hits(11, int(m.mtype.shape[0]))
    kw = dict(has_skin=False, has_disney=True)
    args = (torch.tensor(mat), torch.tensor(ent))
    a = tdispatch.gather(none, *args, **kw)
    b = tdispatch.gather(none, *args, **kw, tex=tdispatch.TexLookup(
        ts.textures, torch.tensor(uv), tv.v3(torch.tensor(p)),
        torch.tensor(fp), torch.tensor(fp_uv), -0.5, 2.2))
    for f in ("diffuse_color", "spec_weight"):
        assert torch.equal(getattr(a, f).aos(), getattr(b, f).aos())


@pytest.mark.parametrize("fp_scale", [1e-3, 1.0])
def test_apply_bump(scenes, fp_scale):
    """Footprints all under the 5e-3 floor (every step at the floor, the
    level of detail fixed by it) and spread over e^-9..1 (both sides)."""
    js, ts = scenes
    mat, _, p, fp, _, _, ns = _hits(12, int(ts.materials.mtype.shape[0]))
    fp = (fp * fp_scale).astype(np.float32)
    # the bump ball's material on half the lanes
    bump = js.material_names.index("bump_node")
    mat[::2] = bump
    a = tdispatch.apply_bump(ts.materials, ts.textures, torch.tensor(mat),
                             tv.v3(torch.tensor(p)), tv.v3(torch.tensor(ns)),
                             torch.tensor(fp), tex_gamma=2.2)
    b = jdispatch.apply_bump(js.materials, js.textures, jnp.asarray(mat),
                             jnp.asarray(p), jnp.asarray(ns),
                             fp=jnp.asarray(fp), tex_gamma=2.2)
    close_mostly(a, b)
    # the grid's lines tilt the normal where a difference step meets one
    moved = np.abs(_np(a) - ns).max(-1) > 1e-4
    assert moved[mat == bump].mean() > 0.1 and not moved[mat != bump].any()


def test_surface_footprint(scenes):
    """_surface's uv, fp and fp_uv on camera-ray hits of the scene with a
    base footprint and a spread per ray."""
    js, ts = scenes
    ja = jtrace.build(js.geometry)
    ta = interop.scene_from_numpy(interop.scene_tables(js, ja), "cpu")[1]
    rs = np.random.default_rng(13)
    o = np.tile(np.array([[0.0, 2.2, 7.0]], np.float32), (N, 1))
    d = rs.normal(size=(N, 3)).astype(np.float32) * 0.3
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    base = rs.uniform(0, 0.01, N).astype(np.float32)
    spread = rs.uniform(1e-4, 1.0, N).astype(np.float32)
    from rlshaders_tpu_torch.accel import trace as ttrace

    hit = ttrace.nearest(ta, torch.tensor(o), torch.tensor(d), vis_mask=1)
    sc = twave.DeviceScene(ts.geometry, ts.materials, ts.quad_lights,
                           ts.disk_lights, ts.sky.radiance, ts.textures, ta,
                           {})
    a = twave._surface(sc, hit.t, hit.tri, hit.u, hit.v, torch.tensor(o),
                       torch.tensor(d), torch.tensor(base),
                       torch.tensor(spread))
    jsc = jwave.device_scene(js, ja)
    b = jwave._surface(jsc, jnp.asarray(hit.t.numpy()),
                       jnp.asarray(hit.tri.numpy()),
                       jnp.asarray(hit.u.numpy()), jnp.asarray(hit.v.numpy()),
                       jnp.asarray(o), jnp.asarray(d), jnp.asarray(base),
                       jnp.asarray(spread))
    assert bool((hit.tri >= 0).float().mean() > 0.9)
    for f in ("uv", "fp", "fp_uv"):
        close(getattr(a, f), getattr(b, f))
    close(a.ns, jv.v3(b.ns))


# ---------------------------------------------------------------------------
# tests/test_r5_semantics.py::test_mayafile_invert_is_storage_space, on the
# port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("invert", ["on", "off"])
def test_mayafile_invert_is_storage_space(tmp_path, invert):
    """`invert` folds in storage space before the texture_gamma decode: a
    uniform c_s = 64/255 texture under invert reads (1 - c_s)^2.2, not the
    linear fold 1 - c_s^2.2 (the JAX package's test, on the port)."""
    c8 = 64
    Image.fromarray(np.full((8, 8, 3), c8, np.uint8), mode="RGB").save(
        tmp_path / "flat.png")
    path = tmp_path / "scene.ass"
    path.write_text(SCENE_INVERT % invert)
    scene = tbuild.build(str(path), device="cpu")
    from rlshaders_tpu_torch.accel import trace as ttrace

    out = twave.render(scene, ttrace.build(scene.geometry), tile_pixels=512)
    got = float(out["RGBA"].numpy().mean(-1)[4:12, 4:12].mean())
    c_s = c8 / 255.0
    factor = (1.0 - c_s) ** 2.2 if invert == "on" else c_s ** 2.2
    want = factor * 0.3  # Kd 1, a uniform dome of 0.3, GI depth 0
    assert abs(got / want - 1.0) < 0.04, (got, want, invert)
