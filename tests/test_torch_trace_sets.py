"""Trace sets in the port against the JAX package: the build's visibility
bits and set names, and the subset accels of `build_trace_set`.

The scene is tests/test_accel.py's two planes (the upper one in "setA")
with a third plane in two sets. BVH arrays are compared exactly with the
JAX package's NumPy builder (its native C++ one switched off, as
tests/test_torch_accel.py does); hits on random rays within 1e-5 in t, u
and v (the port's walk against the JAX package's jitted walk, as
tests/test_torch_accel.py measures), the same triangle but at exact ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import bvh as JB
from rlshaders_tpu.accel import native as jnative
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.scene import build as tbuild

cpu_math.settle()

ATOL = 1e-5

PLANE = """polymesh
{{
 name {name}
 nsides 4
 vidxs 4 1 UINT
0 1 3 2
 vlist 4 1 POINT
-5 0 5 5 0 5 -5 0 -5 5 0 -5
 nlist 4 1 VECTOR
0 1 0 0 1 0 0 1 0 0 1 0
 nidxs 4 1 UINT
0 1 2 3
 matrix
 1 0 0 0
 0 1 0 0
 0 0 1 0
 {x} {y} 0 1
 shader "sg"
{sets}}}
"""

SCENE = """options
{ AA_samples 1 xres 4 yres 4 camera "cam" }
persp_camera
{ name cam
 fov 40
 matrix
 1 0 0 0
 0 0 -1 0
 0 1 0 0
 0 3 0 1
}
""" + PLANE.format(name="upper", x=0, y=1, sets=(
    ' declare trace_sets constant ARRAY STRING\n trace_sets "setA"\n')) \
    + PLANE.format(name="lower", x=0, y=-1, sets="") \
    + PLANE.format(name="side", x=12, y=0, sets=(
        ' declare trace_sets constant ARRAY STRING\n'
        ' trace_sets 2 1 STRING "setB" "setA"\n')) + """MayaShadingEngine
{ name sg beauty mat }
standard
{ name mat Kd 1 }
"""


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = tmp_path_factory.mktemp("ts") / "ts.ass"
    path.write_text(SCENE)
    return jbuild.build(str(path)), tbuild.build(str(path), device="cpu")


def _jax_numpy_accel(geometry, set_bit, inclusive):
    saved = (jnative._lib, jnative._tried)
    jnative._lib, jnative._tried = None, True
    try:
        return jtrace.build_trace_set(geometry, set_bit, inclusive)
    finally:
        jnative._lib, jnative._tried = saved


def test_build_folds_sets_into_visibility(scenes):
    js, ts = scenes
    assert ts.trace_set_names == js.trace_set_names == ["setA", "setB"]
    vis = ts.geometry.visibility.numpy()
    n = vis.shape[0]
    jvis = np.asarray(js.geometry.visibility)
    np.testing.assert_array_equal(vis, jvis[:n])
    assert not jvis[n:].any()          # the JAX build's padding rows
    mesh = ts.geometry.mesh_id.numpy()
    assert (vis[mesh == 0] == 255 | 1 << 8).all()
    assert (vis[mesh == 1] == 255).all()
    assert (vis[mesh == 2] == 255 | 1 << 8 | 1 << 9).all()


@pytest.mark.parametrize("set_bit,inclusive", [(0, True), (0, False),
                                               (1, True), (1, False)])
def test_subset_accel_equals_jax(scenes, set_bit, inclusive):
    js, ts = scenes
    jacc = _jax_numpy_accel(js.geometry, set_bit, inclusive)
    tacc = ttrace.build_trace_set(ts.geometry, set_bit, inclusive)
    for f in JB.BVH._fields:
        np.testing.assert_array_equal(getattr(tacc.tree, f).numpy(),
                                      np.asarray(getattr(jacc.tree, f)),
                                      err_msg=f)
    # the packed tables carry the members' original ids
    mem = (ts.geometry.visibility.numpy() & 1 << (8 + set_bit)) != 0
    want = np.flatnonzero(mem if inclusive else ~mem)
    assert sorted(tacc.tree.tri_order.tolist()) == want.tolist()

    rs = np.random.default_rng(set_bit * 2 + inclusive)
    n = 600
    o = rs.uniform((-8, -4, -8), (20, 4, 8), (n, 3))
    aim = rs.uniform((-6, -1.5, -6), (18, 1.5, 6), (n, 3))
    d = aim - o
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rs.uniform(0.5, 30.0, n).astype(np.float32)
    jh = jtrace.nearest(jacc, js.geometry, jnp.asarray(o), jnp.asarray(d),
                        vis_mask=0xFF)
    th = ttrace.nearest(tacc, torch.tensor(o), torch.tensor(d),
                        vis_mask=0xFF)
    tri_t, tri_j = th.tri.numpy(), np.asarray(jh.tri)
    hits = tri_t[tri_t >= 0]
    assert hits.size > n // 10
    assert (mem[hits] == inclusive).all()
    t_t, t_j = th.t.numpy(), np.asarray(jh.t)
    np.testing.assert_allclose(t_t, t_j, atol=ATOL, rtol=1e-6)
    diff = tri_t != tri_j
    assert np.all((tri_t[diff] >= 0) & (tri_j[diff] >= 0))   # ties only
    same = ~diff & (tri_t >= 0)
    np.testing.assert_allclose(th.u.numpy()[same], np.asarray(jh.u)[same],
                               atol=ATOL)
    np.testing.assert_allclose(th.v.numpy()[same], np.asarray(jh.v)[same],
                               atol=ATOL)
    jo = jtrace.occluded(jacc, js.geometry, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t_max), vis_mask=0xFF)
    to = ttrace.occluded(tacc, torch.tensor(o), torch.tensor(d),
                         torch.tensor(t_max), vis_mask=0xFF)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_subset_queries_skip_non_members(scenes):
    """tests/test_accel.py's check on the port: straight down through both
    planes, the exclusive set hits the lower plane, and a segment ending
    between them is blocked only by the inclusive set."""
    _, ts = scenes
    mesh = ts.geometry.mesh_id
    o = torch.tensor([[0.0, 5.0, 0.0]] * 4)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 4)
    inc = ttrace.build_trace_set(ts.geometry, 0, inclusive=True)
    exc = ttrace.build_trace_set(ts.geometry, 0, inclusive=False)
    assert (mesh[ttrace.nearest(inc, o, d, 0xFF).tri.long()] == 0).all()
    assert (mesh[ttrace.nearest(exc, o, d, 0xFF).tri.long()] == 1).all()
    tmax = torch.full((4,), 5.5)
    assert ttrace.occluded(inc, o, d, tmax, 0xFF).all()
    assert not ttrace.occluded(exc, o, d, tmax, 0xFF).any()


def test_empty_set_keeps_the_reference_quirk(scenes):
    """A set with no member is built over triangle 0 ("one inert tri", the
    JAX code says), as in the JAX package. Triangle 0 is the upper plane's
    first triangle in both packages, so the empty set's queries hit it."""
    js, ts = scenes
    geom = ts.geometry._replace(
        visibility=ts.geometry.visibility & 0xFF)     # no sets
    acc = ttrace.build_trace_set(geom, 0, inclusive=True)
    assert acc.tree.tri_order.tolist() == [0]
    jacc = _jax_numpy_accel(js.geometry._replace(
        visibility=js.geometry.visibility & 0xFF), 0, True)
    assert np.asarray(jacc.tree.tri_order).tolist() == [0]
    o = torch.tensor([[2.0, 5.0, 2.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    hit = ttrace.nearest(acc, o, d, 0xFF)
    assert hit.tri.tolist() == [0] and hit.t.tolist() == [4.0]
    jhit = jtrace.nearest(jacc, js.geometry, jnp.asarray(o.numpy()),
                          jnp.asarray(d.numpy()), vis_mask=0xFF)
    assert np.asarray(jhit.tri).tolist() == [0]
    full = ttrace.build(geom)
    assert ttrace.nearest(full, o, d, 0xFF).tri.tolist() == [0]
