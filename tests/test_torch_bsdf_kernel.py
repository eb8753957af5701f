"""The lobe kernels' arithmetic equals models/dispatch.py's eager code.

`ops/csrc/bsdf.cuh` holds every step of the CUDA lobes (ops/bsdf.py). Here,
with no card and no nvcc, g++ compiles it through `ops/csrc/bsdf_host.cpp`,
which loops over the lanes as the kernels' threads do, with the field table
ops/bsdf.py builds, and every output of the five entry points is held to
the eager torch code on the CPU: every material type (rlGgx; `standard`
with the Fresnel modes 0, 1 and 2 and both distributions; rlDisney with
and without clearcoat, sheen and anisotropy, and at roughness 1, GTR1's
degenerate a2 = 1; rlSkin with and without sheen), tables without the
rlDisney or rlSkin parts (null pointers), and edge lanes: below the
horizon, wo.z at and under 1e-4, grazing and zero wi, wi = -wo, the pole,
TIR in sample_refract, rx at the lobe picks (rlSkin's 0.5, rlDisney's
1 / (clearcoat + 1)) and at 0 and 1 - 2^-24.

Tolerance, measured on these inputs: the host build's square root and
transcendentals (IEEE sqrtf, libm's expf, logf, sinf, cosf, tanf, acosf)
differ from torch's CPU kernels (its vector math library, whose sqrt is
not correctly rounded on every lane) in the last bit, which the lobes
carry on. So an output may differ by ULPS float32 ulps or by ATOL, and a
sampled direction, where a unit vector's components cancel (the cosine
sampler's rim, z = sqrt(1 - x^2 - y^2)), by DIR_ATOL. A lane whose gate
flips on such a difference (a Smith G1's side at grazing wo, a clamp) may
differ by anything: those lanes are counted, at most FLIP_SHARE of a
call's. Measured: directions within 4.4e-4, and at most 4 of 6,144 lanes
(0.07%) beyond, all of them at grazing wo or rx at 1 on the glass.
Also: the tracer's counters of the lobes on the CPU.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from rlshaders_tpu_torch.accel import native
from rlshaders_tpu_torch.bsdf import ggx
from rlshaders_tpu_torch.core import cpu_math, tracer
from rlshaders_tpu_torch.core.vec3 import V3
from rlshaders_tpu_torch.models import dispatch
from rlshaders_tpu_torch.ops import bsdf as kernels
from rlshaders_tpu_torch.scene import build as tbuild

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")
N = 6144
ULPS = 4
ATOL = 1e-6
DIR_ATOL = 1e-3
FLIP_SHARE = 0.002

cpu_math.settle()

MATS_ASS = """
options
{
 AA_samples 1
 xres 4
 yres 4
 camera "cam"
}
persp_camera
{
 name cam
 fov 45
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 0 0 5 1
}
rlGgx
{
 name ggx_aniso
 Kd 0.4
 KdColor 0.7 0.3 0.2
 Ks 0.6
 KsColor 1 0.8 0.6
 specularRoughness 0.3
 anisotropic 0.5
 diffuseRoughness 0.4
 ior 1.5
}
rlGgx
{
 name glass
 Kd 0
 Ks 1
 Kt 1
 KtColor 0.9 0.95 1
 specularRoughness 0.08
 ior 1.5
}
rlGgx
{
 name mirror
 Kd 0
 Ks 1
 specularRoughness 0.01
 ior 0.47
}
standard
{
 name std_ct
 Kd 0.8
 Kd_color 0.6 0.6 0.6
 Ks 0.3
 specular_roughness 0.2
 diffuse_roughness 1
}
standard
{
 name std_ct_fresnel
 Kd 0.5
 Ks 0.5
 specular_Fresnel on
 Ksn 0.1
 specular_roughness 0.6
}
standard
{
 name std_ggx
 Kd 0.5
 Ks 0.5
 Ks_color 0.9 0.9 1
 specular_brdf "ggx"
 specular_Fresnel on
 Ksn 0.3
 specular_roughness 0.4
}
standard
{
 name std_ggx_plain
 Kd 0.2
 Ks 0.7
 specular_brdf "ggx"
 specular_roughness 0.05
}
rlDisney
{
 name disney_plain
 base_color 0.8 0.2 0.1
 roughness 0.5
}
rlDisney
{
 name disney_full
 base_color 0.3 0.6 0.9
 subsurface 0.4
 metallic 0.3
 specular 0.5
 specular_tint 0.2
 roughness 0.35
 anisotropic 0.6
 sheen 0.5
 sheen_tint 0.3
 clearcoat 0.8
 clearcoat_gloss 0.9
}
rlDisney
{
 name disney_rough
 base_color 0.5 0.5 0.5
 metallic 1
 roughness 1
 clearcoat 1
 clearcoat_gloss 0.2
}
rlSkin
{
 name skin_sheen
 sss_color 0.92 0.78 0.62
 sss_weight 0.8
 specular_weight 0.35
 specular_roughness 0.35
 specular_ior 1.44
 sheen_weight 0.2
 sheen_roughness 0.3
}
rlSkin
{
 name skin_bare
 sss_color 0.5 0.6 0.7
 specular_weight 0.6
 specular_roughness 0.5
}
"""
SHADERS = ("ggx_aniso", "glass", "mirror", "std_ct", "std_ct_fresnel",
           "std_ggx", "std_ggx_plain", "disney_plain", "disney_full",
           "disney_rough", "skin_sheen", "skin_bare")
SKINS = {"skin_sheen", "skin_bare"}
DISNEYS = {"disney_plain", "disney_full", "disney_rough"}


def _mesh(i, shader):
    return f"""
polymesh
{{
 name m{i}
 nsides 1 1 UINT
3
 vidxs 3 1 UINT
0 1 2
 vlist 3 1 POINT
{i} 0 0 {i + 1} 0 0 {i} 1 0
 shader "{shader}"
}}
"""


@pytest.fixture(scope="module")
def host():
    lib = ctypes.CDLL(native.build(
        native.EXACT_FLAGS, os.path.join(CSRC, "bsdf_host.cpp"),
        "librls_bsdf_host", headers=(os.path.join(CSRC, "bsdf.cuh"),)))
    for name in kernels.LAUNCHES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def scene():
    text = MATS_ASS + "".join(_mesh(i, s) for i, s in enumerate(SHADERS))
    return tbuild.build_text(text, device="cpu")


def _dirs(rs, n, upper=None):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if upper is not None:
        d[:, 2] = np.abs(d[:, 2]) * (1 if upper else -1)
    return d


def _edges(d: np.ndarray, rs) -> np.ndarray:
    """Overwrite a few rows of unit directions with the edge cases."""
    k = d.shape[0] // 16
    rows = rs.permutation(d.shape[0])[:8 * k].reshape(8, k)
    flat = _dirs(rs, k)
    d[rows[0], 2] = rs.choice([0.0, 1e-4, 5e-5, -1e-4, 1e-7], k)  # horizon
    d[rows[1]] = [0.0, 0.0, 1.0]                                   # pole
    d[rows[2]] = [0.0, 0.0, -1.0]
    d[rows[3]] = flat * [1, 1, 1e-6]                               # grazing
    d[rows[4], 2] = np.float32(1e-5)
    d[rows[5]] = 0.0                                               # zero
    d[rows[6]] = np.abs(flat) * [1, 1, 1]
    d[rows[7], :2] = 0.0
    return d


def _lanes(scene, seed, tables):
    """(MatG, wo, wi, rx, ry) over N lanes of random materials of the
    scene; `tables` says which parts the gather keeps ("all",
    "no_skin", "no_disney", "neither"); wi = -wo, wi = wo and rx at the
    lobe picks on some lanes."""
    rs = np.random.default_rng(seed)
    names = SHADERS
    if tables in ("no_skin", "neither"):
        names = [s for s in names if s not in SKINS]
    if tables in ("no_disney", "neither"):
        names = [s for s in names if s not in DISNEYS]
    ids = [scene.material_names.index(s) for s in names]
    mat_id = torch.tensor(rs.choice(ids, N), dtype=torch.int32)
    entering = torch.tensor(rs.random(N) < 0.6)
    m = dispatch.gather(scene.materials, mat_id, entering,
                        has_skin=tables in ("all", "no_disney"),
                        has_disney=tables in ("all", "no_skin"))
    wo = _edges(_dirs(rs, N), rs)
    wo[: N // 2, 2] = np.abs(wo[: N // 2, 2])
    wi = _edges(_dirs(rs, N), rs)
    k = N // 32
    wi[:k] = -wo[:k]
    wi[k:2 * k] = wo[k:2 * k]
    wi[2 * k:3 * k] = wo[2 * k:3 * k] * [-1, -1, 1]
    rx = rs.random(N).astype(np.float32)
    ry = rs.random(N).astype(np.float32)
    picks = rs.permutation(N)[:6 * k].reshape(6, k)
    rx[picks[0]] = 0.5
    rx[picks[1]] = np.nextafter(np.float32(0.5), np.float32(0))
    rx[picks[2]] = 0.0
    rx[picks[3]] = np.float32(1 - 2**-24)
    ry[picks[4]] = rs.choice([0.0, 0.5, np.float32(1 - 2**-24)], k)
    if m.dsy is not None:
        # rlDisney's lobe pick, 1 / (clearcoat + 1) as the eager code has it
        gtr2_w = (1.0 / (m.dsy.clearcoat + 1.0)).numpy()
        rx[picks[5]] = gtr2_w[picks[5]]
    t = lambda a: V3(*(torch.tensor(np.ascontiguousarray(a[:, c]))
                       for c in range(3)))
    return m, t(wo), t(wi), torch.tensor(rx), torch.tensor(ry)


def _shuffled(m, seed):
    """Every Fresnel mode and distribution on every kind of lane."""
    rs = np.random.default_rng(seed)
    return m._replace(
        spec_fresnel_mode=torch.tensor(rs.integers(0, 3, N),
                                       dtype=torch.int32),
        spec_dist=torch.tensor(rs.integers(0, 2, N), dtype=torch.int32))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 ulp distance; 0 where equal (NaN with NaN, -0 with +0)."""
    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(key(a) - key(b))
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return np.where(same, 0, d)


def _rows(x) -> np.ndarray:
    if isinstance(x, V3):
        return np.stack([c.numpy() for c in x])
    if isinstance(x, tuple):
        return np.concatenate([_rows(a) for a in x])
    return x.numpy()[None]


def _compare(got: torch.Tensor, want, what: str) -> dict:
    """The host rows against the eager outputs: sampled directions (the
    first three rows of a sampler) within DIR_ATOL, every other output
    within ULPS ulps or ATOL; the lanes beyond are counted, at most
    FLIP_SHARE of the call's."""
    g, w = got.numpy(), _rows(want)
    assert g.shape == w.shape, what
    diff = np.abs(g - w)
    diff = np.where(np.isnan(g) & np.isnan(w), 0.0, diff)
    ok = (_ulps(g, w) <= ULPS) | (diff <= ATOL)
    if what.startswith("sample"):
        ok[:3] = diff[:3] <= DIR_ATOL
    beyond = int((~ok.all(axis=0)).sum())
    stats = {"beyond": beyond, "dir_err": float(np.nanmax(diff[:3]))}
    assert beyond <= FLIP_SHARE * g.shape[1], (what, stats)
    return stats


def _entry_calls(m, wo, wi, rx, ry):
    """(entry, eager output, kernel arguments) of every entry point."""
    return [
        ("eval_diffuse", dispatch.eval_diffuse(m, wo, wi),
         dict(wo=wo, wi=wi)),
        ("sample_diffuse", dispatch.sample_diffuse(m, wo, rx, ry),
         dict(rx=rx, ry=ry)),
        ("eval_specular", dispatch.eval_specular(m, wo, wi),
         dict(wo=wo, wi=wi)),
        ("sample_specular", dispatch.sample_specular(m, wo, rx, ry),
         dict(wo=wo, rx=rx, ry=ry)),
        ("sample_refract", dispatch.sample_refract(m, wo, rx, ry),
         dict(wo=wo, rx=rx, ry=ry)),
    ]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("tables", ["all", "no_skin", "no_disney", "neither"])
def test_entry_points_equal_eager(host, scene, tables, shuffle):
    m, wo, wi, rx, ry = _lanes(scene, 250 + len(tables), tables)
    if shuffle:
        m = _shuffled(m, 251)
    for entry, want, kw in _entry_calls(m, wo, wi, rx, ry):
        got = kernels.run(host, entry, m, **kw)
        _compare(got, want, f"{entry} {tables} shuffle={shuffle}")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sampled_directions_evaluate_equal(host, scene, seed):
    """The main path's order: wi sampled by each lobe, then evaluated."""
    m, wo, _, rx, ry = _lanes(scene, seed, "all")
    for sampler, evaluator in (("sample_diffuse", "eval_diffuse"),
                               ("sample_specular", "eval_specular")):
        wi = getattr(dispatch, sampler)(m, wo, rx, ry)
        got = kernels.run(host, evaluator, m, wo=wo, wi=wi)
        _compare(got, getattr(dispatch, evaluator)(m, wo, wi), evaluator)


@pytest.mark.parametrize("kind", sorted(SHADERS))
def test_each_material_alone(host, scene, kind):
    """One material on every lane: its model and nothing else."""
    m, wo, wi, rx, ry = _lanes(scene, 7, "all")
    mid = torch.full((N,), scene.material_names.index(kind),
                     dtype=torch.int32)
    m = dispatch.gather(scene.materials, mid, torch.ones(N, dtype=torch.bool),
                        has_skin=True, has_disney=True)
    for entry, want, kw in _entry_calls(m, wo, wi, rx, ry):
        _compare(kernels.run(host, entry, m, **kw), want, f"{entry} {kind}")


def test_edge_lanes_occur(scene):
    """The inputs reach TIR, GTR1's a2 = 1, the horizon and the lobe picks
    (a test that passes without them would hold nothing)."""
    m, wo, _, rx, ry = _lanes(scene, 250 + 3, "all")
    _, _, tir = ggx.sample_refract(m.ggx, wo, rx, ry)
    assert 0 < int(tir.sum()) < N
    assert bool(((m.dsy.roughness == 1.0)
                 & (m.mtype == tbuild.MAT_DISNEY)).any())
    assert bool(((wo.z.abs() <= 1e-4) & (wo.z.abs() > 0)).any())
    assert bool((rx == 0.5).any())
    gtr2_w = 1.0 / (m.dsy.clearcoat + 1.0)
    assert bool(((rx == gtr2_w) & (m.dsy.clearcoat > 0)
                 & (m.mtype == tbuild.MAT_DISNEY)).any())


def test_table_reads_strides_and_0dim_fields(host, scene):
    """Strided lanes (u[:, 0] of an (N, 2) draw) and 0-dim fields are read
    as the eager code reads them."""
    m, wo, wi, rx, ry = _lanes(scene, 5, "all")
    u = torch.stack([rx, ry], 1)
    m = m._replace(sheen_layer=torch.tensor(0.75))
    for entry, want, kw in _entry_calls(m, wo, wi, u[:, 0], u[:, 1]):
        _compare(kernels.run(host, entry, m, **kw), want, entry)


def test_table_refuses_bad_fields(scene):
    m, wo, wi, _, _ = _lanes(scene, 6, "all")
    cpu = torch.device("cpu")
    with pytest.raises(TypeError):
        kernels.table("eval_specular",
                      m._replace(spec_ksn=m.spec_ksn.double()),
                      wo, wi, None, None, N, cpu)
    with pytest.raises(TypeError):
        kernels.table("eval_specular", m._replace(mtype=m.mtype.long()),
                      wo, wi, None, None, N, cpu)
    with pytest.raises(ValueError):
        kernels.table("eval_specular", m, V3(wo.x[:7], wo.y, wo.z), wi,
                      None, None, N, cpu)
    with pytest.raises(ValueError):
        kernels.table("eval_diffuse", m, wo, wi, None, None, N,
                      torch.device("meta"))
    with pytest.raises(ValueError):
        kernels.eval_diffuse(m, wo, wi)   # the kernels need CUDA tensors
    args = kernels.table("eval_diffuse", m._replace(dsy=None), wo, wi,
                         None, None, N, cpu)
    pairs = np.asarray(args).reshape(-1, 2)
    assert len(pairs) == kernels.FIELDS
    # the parts eval_diffuse does not read, and the absent dsy, are null
    assert (pairs[:, 0] != 0).sum() == 6 + 1 + 1 + 3 + 1


def test_empty_call(host, scene):
    m, wo, wi, _, _ = _lanes(scene, 6, "all")
    e = lambda a: a[:0]
    got = kernels.run(host, "eval_specular", m._replace(), wo=V3(*map(e, wo)),
                      wi=V3(*map(e, wi)))
    assert got.shape == (4, 0)


def test_bsdf_counters_on_the_cpu(scene):
    """Every lobe call counts its lanes; on the CPU no kernel handles
    any."""
    m, wo, wi, rx, ry = _lanes(scene, 9, "all")
    tracer.take()
    with tracer.enabled(counters=True):
        _entry_calls(m, wo, wi, rx, ry)
        _, counters = tracer.take()
    assert counters["bsdf_lanes"] == 5 * N
    assert counters["bsdf_kernel_lanes"] == 0
