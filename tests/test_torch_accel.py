"""The port's plain BVH walk against the JAX package's skip-link BVH.

Both walk the same tree (built by the JAX package and handed over as
arrays), so hit records must agree: triangle ids exactly except at exact
ties in t, where either package may keep another of the equal-t triangles
(the port keeps the first met in the walk, as the JAX BVH does; the TPU
kernel kept the largest id). t, u and v agree to float32 rounding: both
compute the same Moller-Trumbore expressions, but XLA may contract a
multiply and an add into one fused operation where torch rounds twice, so
a few ulps (atol 1e-5 at the scene's unit scale) are allowed.

The CUDA kernels cannot run here; tests/test_torch_gpu.py holds them to
this plain walk on a card (marker `gpu`), and chip_smoke.py does the same
on every query of a 256x256 frame.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import bvh as JB
from rlshaders_tpu.accel import native as jnative
from rlshaders_tpu_torch.accel import bvh as TB
from rlshaders_tpu_torch.accel import trace as ttrace

ATOL = 1e-5


def _soup(t=600, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, e1, e2


def _rays(r=800, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _numpy_jax_tree(v0, e1, e2):
    """The JAX package's NumPy builder (its native C++ one switched off)."""
    saved = (jnative._lib, jnative._tried)
    jnative._lib, jnative._tried = None, True
    try:
        return JB.build(v0, e1, e2)
    finally:
        jnative._lib, jnative._tried = saved


def _port_accel(jtree, v0, e1, e2, vis=None, opaque=None):
    t = v0.shape[0]
    geom = types.SimpleNamespace(
        v0=torch.tensor(v0), e1=torch.tensor(e1), e2=torch.tensor(e2),
        visibility=torch.tensor(np.full(t, 255, np.int32) if vis is None
                                else vis),
        opaque=torch.tensor(np.ones(t, bool) if opaque is None else opaque),
    )
    return ttrace.from_arrays(geom, *(np.asarray(getattr(jtree, f))
                                      for f in JB.BVH._fields))


def _assert_hits_agree(th, jh):
    t_t, tri_t = th.t.numpy(), th.tri.numpy()
    t_j, tri_j = np.asarray(jh.t), np.asarray(jh.tri)
    np.testing.assert_allclose(t_t, t_j, atol=ATOL, rtol=1e-6)
    diff = tri_t != tri_j
    # a differing id is only allowed at a tie: both ids hit at the same t
    assert np.all((tri_t[diff] >= 0) & (tri_j[diff] >= 0))
    np.testing.assert_allclose(t_t[diff], t_j[diff], atol=ATOL)
    same = ~diff & (tri_t >= 0)
    np.testing.assert_allclose(th.u.numpy()[same], np.asarray(jh.u)[same],
                               atol=ATOL)
    np.testing.assert_allclose(th.v.numpy()[same], np.asarray(jh.v)[same],
                               atol=ATOL)
    return int(diff.sum())


@pytest.mark.parametrize("t,seed", [(600, 0), (1200, 11), (7, 3)])
def test_build_equals_jax_numpy_builder(t, seed):
    v0, e1, e2 = _soup(t, seed)
    jt = _numpy_jax_tree(v0, e1, e2)
    arrays = TB.build_arrays(v0, e1, e2)
    for f, a in zip(JB.BVH._fields, arrays):
        np.testing.assert_array_equal(a, np.asarray(getattr(jt, f)), err_msg=f)


@pytest.mark.parametrize("t,r,seed", [(600, 800, 0), (900, 700, 3),
                                      (50, 300, 9)])
def test_plain_nearest_matches_jax_bvh(t, r, seed):
    v0, e1, e2 = _soup(t, seed)
    jt = JB.build(v0, e1, e2)
    acc = _port_accel(jt, v0, e1, e2)
    o, d = _rays(r, seed + 1)
    jh = JB.intersect(jt, jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                      jnp.asarray(o), jnp.asarray(d))
    th = ttrace.nearest(acc, torch.tensor(o), torch.tensor(d), vis_mask=255)
    assert _assert_hits_agree(th, jh) == 0
    assert (th.tri.numpy() >= 0).any()


def test_plain_walk_matches_brute_force_on_own_tree():
    v0, e1, e2 = _soup(600, 0)
    t = v0.shape[0]
    geom = types.SimpleNamespace(
        v0=torch.tensor(v0), e1=torch.tensor(e1), e2=torch.tensor(e2),
        visibility=torch.full((t,), 255, dtype=torch.int32),
        opaque=torch.ones(t, dtype=torch.bool))
    acc = ttrace.build(geom)
    o, d = _rays(800, 1)
    h = ttrace.nearest(acc, torch.tensor(o), torch.tensor(d), vis_mask=255)
    ok, tt, _, _ = JB._tri_test(
        jnp.asarray(v0)[None], jnp.asarray(e1)[None], jnp.asarray(e2)[None],
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], 1e-4, 1e30)
    t_all = np.where(np.asarray(ok), np.asarray(tt), 1e30)
    t_ref = t_all.min(axis=1)
    tri_ref = np.where(t_ref < 1e30, t_all.argmin(axis=1), -1)
    np.testing.assert_allclose(h.t.numpy(), t_ref, atol=ATOL, rtol=1e-6)
    assert np.array_equal(h.tri.numpy(), tri_ref)


def test_plain_occluded_matches_jax_bvh():
    v0, e1, e2 = _soup(900, 3)
    rng = np.random.default_rng(5)
    opaque = rng.random(900) < 0.7
    vis = np.where(rng.random(900) < 0.5, 2, 1 | 2).astype(np.int32)
    jt = JB.build(v0, e1, e2)
    acc = _port_accel(jt, v0, e1, e2, vis, opaque)
    o, d = _rays(700, 4)
    t_max = rng.uniform(-0.5, 3.0, 700).astype(np.float32)
    ex = np.where(rng.random(700) < 0.3, rng.integers(0, 900, 700), -1)
    for vis_mask in (1, 2, 3):
        jb = JB.occluded(jt, jnp.asarray(v0), jnp.asarray(e1),
                         jnp.asarray(e2), jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t_max),
                         exclude_tri=jnp.asarray(ex, jnp.int32),
                         vis_mask=vis_mask, tri_visibility=jnp.asarray(vis),
                         tri_opaque=jnp.asarray(opaque))
        tb = ttrace.occluded(acc, torch.tensor(o), torch.tensor(d),
                             torch.tensor(t_max), vis_mask=vis_mask,
                             exclude_tri=torch.tensor(ex, dtype=torch.int32))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tb.numpy().sum() > 50


def test_axis_aligned_rays_with_negative_zero_components():
    v0 = np.array([[-1, 0, -1]], np.float32)
    e1 = np.array([[2, 0, 0]], np.float32)
    e2 = np.array([[0, 0, 2]], np.float32)
    acc = _port_accel(JB.build(v0, e1, e2), v0, e1, e2)
    o = torch.tensor([[-0.5, 2.0, -0.5]] * 4)
    d = torch.tensor([[-0.0, -1.0, dz] for dz in (0.0, -0.0, -2.2e-16,
                                                  2.2e-16)])
    h = ttrace.nearest(acc, o, d, vis_mask=255)
    assert h.tri.tolist() == [0, 0, 0, 0]
    np.testing.assert_allclose(h.t.numpy(), 2.0, atol=1e-4)
    assert bool(ttrace.occluded(acc, o, d, torch.full((4,), 3.0),
                                vis_mask=255).all())


def test_visibility_mask_exclude_and_dead_lanes():
    v0, e1, e2 = _soup(100, 7)
    vis = np.where(np.arange(100) % 2 == 0, 1, 2).astype(np.int32)
    jt = JB.build(v0, e1, e2)
    acc = _port_accel(jt, v0, e1, e2, vis)
    o, d = _rays(400, 8)
    rng = np.random.default_rng(3)
    t_max = np.where(rng.random(400) < 0.2, rng.choice([0.0, -2.0], 400),
                     rng.uniform(0.5, 4.0, 400)).astype(np.float32)
    args = (jt, jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
            jnp.asarray(o), jnp.asarray(d))
    for vis_mask in (1, 2):
        h = ttrace.nearest(acc, torch.tensor(o), torch.tensor(d),
                           vis_mask=vis_mask, t_max=torch.tensor(t_max))
        jh = JB.intersect(*args, t_max=jnp.asarray(t_max), vis_mask=vis_mask,
                          tri_visibility=jnp.asarray(vis))
        _assert_hits_agree(h, jh)
        tri = h.tri.numpy()
        assert np.all(vis[tri[tri >= 0]] & vis_mask)
        dead = t_max <= 0
        assert np.all(tri[dead] == -1)
        np.testing.assert_array_equal(h.t.numpy()[dead], t_max[dead])
    # exclude_tri: excluding each ray's first hit finds another triangle
    h0 = ttrace.nearest(acc, torch.tensor(o), torch.tensor(d), vis_mask=3)
    h1 = ttrace.nearest(acc, torch.tensor(o), torch.tensor(d), vis_mask=3,
                        exclude_tri=h0.tri)
    jh1 = JB.intersect(*args, exclude_tri=jnp.asarray(h0.tri.numpy()),
                       vis_mask=3, tri_visibility=jnp.asarray(vis))
    _assert_hits_agree(h1, jh1)
    sel = h0.tri.numpy() >= 0
    assert np.all(h1.tri.numpy()[sel] != h0.tri.numpy()[sel])


def _demo_frame_queries():
    """Every ray query of a 32x32 port render of the demo scene on the
    JAX package's tables and tree, with that geometry."""
    from rlshaders_tpu.parallel import mesh
    from rlshaders_tpu_torch import interop
    from rlshaders_tpu_torch.integrator import wavefront

    jscene, jaccel = mesh.demo_scene(skin=False)
    scene, accel = interop.scene_from_numpy(
        interop.scene_tables(jscene, jaccel), "cpu")
    calls = []
    real = ttrace.nearest, ttrace.occluded

    def nearest(acc, o, d, vis_mask, exclude_tri=None, t_eps=1e-4,
                t_max=None):
        h = real[0](acc, o, d, vis_mask, exclude_tri, t_eps, t_max)
        calls.append(("nearest", o, d, t_max, exclude_tri, vis_mask, h))
        return h

    def occluded(acc, o, d, t_max, vis_mask, exclude_tri=None, t_eps=1e-4):
        b = real[1](acc, o, d, t_max, vis_mask, exclude_tri, t_eps)
        calls.append(("occluded", o, d, t_max, exclude_tri, vis_mask, b))
        return b

    ttrace.nearest, ttrace.occluded = nearest, occluded
    try:
        wavefront.render(scene, accel, device="cpu", aa_samples=2, xres=32,
                         yres=32)
    finally:
        ttrace.nearest, ttrace.occluded = real
    return jscene, jaccel, calls


def test_all_rays_of_a_demo_frame():
    jscene, jaccel, calls = _demo_frame_queries()
    g = jscene.geometry
    n_near = n_occ = live = ties = 0
    for kind, o, d, t_max, ex, vis_mask, res in calls:
        r = o.shape[0]
        ex_j = (jnp.full((r,), -1, jnp.int32) if ex is None
                else jnp.asarray(ex.numpy()))
        common = dict(exclude_tri=ex_j, vis_mask=vis_mask,
                      tri_visibility=g.visibility)
        if kind == "nearest":
            jh = JB.intersect(
                jaccel.tree, g.v0, g.e1, g.e2, jnp.asarray(o.numpy()),
                jnp.asarray(d.numpy()),
                t_max=(1e30 if t_max is None else jnp.asarray(t_max.numpy())),
                **common)
            ties += _assert_hits_agree(res, jh)
            n_near += r
        else:
            jb = JB.occluded(
                jaccel.tree, g.v0, g.e1, g.e2, jnp.asarray(o.numpy()),
                jnp.asarray(d.numpy()), jnp.asarray(t_max.numpy()),
                tri_opaque=g.opaque, **common)
            np.testing.assert_array_equal(res.numpy(), np.asarray(jb))
            n_occ += r
            live += int((t_max > 0).sum())
    # 4 nearest and 21 shadow queries per camera ray (32x32 pixels, AA 2)
    assert (n_near, n_occ) == (4 * 4096, 21 * 4096)
    assert live > 4096
    assert ties <= 4
