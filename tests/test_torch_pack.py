"""The kernels' packed tables (ops/intersect.py::pack) against the
structure-of-arrays tables they are packed from.

A node is one 32-byte record, (bbox_min.xyz, code) and (bbox_max.xyz,
miss), with code -1 for an inner node and first << 3 | count for a leaf; a
triangle slot is one 48-byte record, (v0.xyz, id), (e1.xyz, vis), (e2.xyz,
opaque). The floats are moved, not recomputed, so unpacking with torch ops
must give back exactly the tables the plain walk reads. The subtree cut
over which the any-hit kernel splits a walk holds every leaf once, and the
plain any-hit walk over its subtrees, ORed, equals the walk over the whole
tree. Which tables the kernels stage in shared memory follows from their
size: the demo and glass scenes fit whole; 4,000- and 12,000-triangle
soups do not, and read both tables from global memory.
"""
import types

import numpy as np
import pytest
import torch

from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.accel import bvh as TB
from rlshaders_tpu_torch.accel import trace
from rlshaders_tpu_torch.ops import intersect as kernels
from rlshaders_tpu_torch.scene.build import build
from rlshaders_tpu_torch.scene.demo import demo_scene
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()


def _soup(t, seed=8, size=0.05):
    rs = np.random.default_rng(seed)
    geom = types.SimpleNamespace(
        v0=torch.tensor(rs.uniform(-1, 1, (t, 3)), dtype=torch.float32),
        e1=torch.tensor(rs.uniform(-size, size, (t, 3)), dtype=torch.float32),
        e2=torch.tensor(rs.uniform(-size, size, (t, 3)), dtype=torch.float32),
        visibility=torch.tensor(rs.integers(1, 256, t), dtype=torch.int32),
        opaque=torch.tensor(rs.random(t) < 0.7),
    )
    return trace.build(geom)


def _unpack(packed):
    """The structure-of-arrays tables back from the packed records."""
    f32 = torch.float32
    nodes, slots = packed.nodes, packed.tris
    code = nodes[:, 3]
    leaf = code >= 0
    tree = TB.BVH(
        bbox_min=nodes[:, 0:3].contiguous().view(f32),
        bbox_max=nodes[:, 4:7].contiguous().view(f32),
        first=torch.where(leaf, code >> 3, -1),
        count=torch.where(leaf, code & 7, 0),
        miss=nodes[:, 7].contiguous(),
        tri_order=slots[:, 3].contiguous(),
    )
    tris = TB.Tris(
        v0=slots[:, 0:3].contiguous().view(f32),
        e1=slots[:, 4:7].contiguous().view(f32),
        e2=slots[:, 8:11].contiguous().view(f32),
        vis=slots[:, 7].contiguous(), opaque=slots[:, 11] != 0,
    )
    return tree, tris


def _accels():
    _, demo = demo_scene(skin=False, device="cpu")
    glass = build("scenes/glass_sphere.ass", device="cpu")
    return {"demo": demo, "glass": trace.build(glass.geometry),
            "soup": _soup(600, size=0.3)}


@pytest.fixture(scope="module")
def accels():
    return _accels()


@pytest.mark.parametrize("name", ["demo", "glass", "soup"])
def test_packed_tables_unpack_to_the_plain_tables(accels, name):
    acc = accels[name]
    tree, tris = _unpack(acc.packed)
    for a, b in ((tree, acc.tree), (tris, acc.tris)):
        for f, x, y in zip(a._fields, a, b):
            assert x.dtype == y.dtype, f
            assert torch.equal(x, y), f
    # every leaf's code, and no inner node's, is first << 3 | count
    leaf = acc.tree.first >= 0
    code = acc.packed.nodes[:, 3]
    assert bool(leaf.any()) and bool((~leaf).any())
    assert torch.equal(code[leaf],
                       (acc.tree.first[leaf] << 3) | acc.tree.count[leaf])
    assert bool((code[~leaf] == -1).all())


@pytest.mark.parametrize("name", ["demo", "glass", "soup"])
def test_record_sizes_and_alignment(accels, name):
    p = accels[name].packed
    n, t = accels[name].tree.first.shape[0], accels[name].tris.v0.shape[0]
    assert p.nodes.dtype == p.tris.dtype == torch.int32
    assert tuple(p.nodes.shape) == (n, kernels.NODE_WORDS)
    assert tuple(p.tris.shape) == (t, kernels.TRI_WORDS)
    assert p.nodes.element_size() * kernels.NODE_WORDS == 32
    assert p.tris.element_size() * kernels.TRI_WORDS == 48
    for x in (p.nodes, p.tris):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0


def test_scene_table_bytes(accels):
    """The byte counts the kernels stage: 1,856 B (demo), 68,736 B
    (glass: 609 nodes, 1,026 triangles)."""
    def nbytes(p):
        return p.nodes.numel() * 4 + p.tris.numel() * 4

    assert nbytes(accels["demo"].packed) == 19 * 32 + 26 * 48 == 1856
    assert nbytes(accels["glass"].packed) == 609 * 32 + 1026 * 48 == 68736


@pytest.mark.parametrize("t,path", [(600, "shared"), (4000, "global"),
                                    (12000, "global")])
def test_path_follows_table_size(accels, t, path):
    assert accels["demo"].packed.path == "shared"
    assert accels["glass"].packed.path == "shared"
    acc = _soup(t)
    n = acc.tree.first.shape[0]
    assert acc.packed.path == path
    assert kernels.table_path(n, t) == path
    assert (n * 32 + t * 48 <= kernels.TABLE_ROOM) == (path == "shared")
    if t == 4000:
        # the nodes alone would fit; only the whole tables count
        assert n * 32 <= kernels.TABLE_ROOM < n * 32 + t * 48
    if t == 12000:
        # neither table alone fits (8,000-odd nodes: about 258 KB)
        assert n * 32 > kernels.TABLE_ROOM and t * 48 > kernels.TABLE_ROOM


def test_table_room_is_an_h100_block():
    assert kernels.SMEM_OPTIN_BYTES == 227 * 1024
    assert kernels.table_path(0, 0) == "shared"
    room = kernels.TABLE_ROOM
    assert kernels.table_path(room // 32, 0) == "shared"
    assert kernels.table_path(room // 32 + 1, 0) == "global"
    assert kernels.table_path(1, room // 48 + 1) == "global"
    assert set(kernels.PATHS) == {"shared", "global"}


def test_pack_refuses_bad_tables():
    acc = _soup(50, size=0.3)
    with pytest.raises(TypeError):
        kernels.pack(acc.tree._replace(miss=acc.tree.miss.long()), acc.tris)
    with pytest.raises(ValueError, match="more than"):
        kernels.pack(acc.tree._replace(count=acc.tree.count + 5), acc.tris)
    with pytest.raises(ValueError, match="shape"):
        kernels.pack(acc.tree, acc.tris._replace(v0=acc.tris.v0[:-1]))


def test_kernels_refuse_cpu_tables():
    acc = _soup(50, size=0.3)
    o = torch.zeros((4, 3))
    tm = torch.ones(4)
    ex = torch.full((4,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.nearest(acc.packed, o, o, tm, ex, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.occluded(acc.packed, o, o, tm, ex, 1)


def test_interop_accel_packs_the_jax_tables():
    """The Accel built from the JAX package's tables carries packed tables
    equal to a repack of its own structure-of-arrays tables, and those
    equal the JAX package's BVH arrays."""
    from rlshaders_tpu.parallel import mesh

    jscene, jaccel = mesh.demo_scene(skin=False)
    tables = interop.scene_tables(jscene, jaccel)
    _, acc = interop.scene_from_numpy(tables, "cpu")
    again = kernels.pack(acc.tree, acc.tris)
    assert torch.equal(acc.packed.nodes, again.nodes)
    assert torch.equal(acc.packed.tris, again.tris)
    assert torch.equal(acc.packed.cut, again.cut)
    assert acc.packed.path == again.path == "shared"
    tree, _ = _unpack(acc.packed)
    for f in TB.BVH._fields:
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      np.asarray(tables[f"bvh.{f}"]),
                                      err_msg=f)


def _subtree(tree, root):
    """The BVH of the subtree at `root` (its nodes are contiguous in DFS
    order), with its links shifted to start at 0."""
    end = int(tree.miss[root])
    return TB.BVH(bbox_min=tree.bbox_min[root:end],
                  bbox_max=tree.bbox_max[root:end],
                  first=tree.first[root:end], count=tree.count[root:end],
                  miss=tree.miss[root:end] - root, tri_order=tree.tri_order)


@pytest.mark.parametrize("name", ["demo", "glass", "soup"])
def test_cut_holds_every_leaf_once(accels, name):
    tree, cut = accels[name].tree, accels[name].packed.cut
    roots = cut.tolist()
    assert cut.dtype == torch.int32 and roots == sorted(set(roots))
    assert 1 <= len(roots) <= kernels.CUT_PARTS
    n = tree.first.shape[0]
    cover = torch.zeros(n, dtype=torch.int64)
    for r in roots:
        cover[r:int(tree.miss[r])] += 1
    leaf = tree.first >= 0
    assert bool((cover[leaf] == 1).all())
    assert bool((cover <= 1).all())
    if n > 2 * kernels.CUT_PARTS:
        assert len(roots) == kernels.CUT_PARTS


@pytest.mark.parametrize("name", ["glass", "soup"])
def test_any_hit_over_the_cut_equals_the_walk(accels, name):
    """The any-hit kernel's split: OR of the plain walk over each subtree
    of the cut equals the plain walk over the tree, lane for lane."""
    acc = accels[name]
    rs = np.random.default_rng(3)
    n = 3000
    lo = acc.tree.bbox_min[0].numpy()
    hi = acc.tree.bbox_max[0].numpy()
    o = torch.tensor(rs.uniform(lo, hi, (n, 3)), dtype=torch.float32)
    d = torch.tensor(rs.normal(size=(n, 3)), dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    tm = torch.tensor(rs.uniform(-0.5, 2.0 * float(np.abs(hi - lo).max()),
                                 n), dtype=torch.float32)
    ex = torch.tensor(np.where(rs.random(n) < 0.3,
                               rs.integers(0, acc.tris.v0.shape[0], n), -1),
                      dtype=torch.int32)
    for vis_mask in (1, 2):
        whole = TB.occluded(acc.tree, acc.tris, o, d, tm, ex, vis_mask)
        split = torch.zeros(n, dtype=torch.bool)
        for r in acc.packed.cut.tolist():
            split |= TB.occluded(_subtree(acc.tree, r), acc.tris, o, d, tm,
                                 ex, vis_mask)
        assert torch.equal(split, whole)
        assert 0 < int(whole.sum()) < n
