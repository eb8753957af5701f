"""The port's native BVH builder (accel/native.py over its copy of
accel/csrc/accel.cpp) against the JAX package's default builder, which is
the same C++ source wherever g++ exists, and against the port's plain
NumPy builder (accel/bvh.py::build_arrays).

With the JAX module's flags on one machine, the two packages' native trees
are equal, all six arrays, from a 7-triangle soup to the 1,572,866
triangles of the dense Disney scene (tools/make_dense_disney.py), and
`trace.build` of every scene of the repository equals the JAX package's.
The plain builder gives the same five node arrays and every leaf the same
set of triangles as the native one on random soups, and on the dense
scene's 64 x 32-quad copy as the native one compiled without fused
multiply-adds (`native.EXACT_FLAGS`): with the JAX module's flags, g++
fuses the SAH cost on a CPU with FMA, and on that copy's near-tied splits
its tree has 14,539 nodes against the plain builder's 14,535 (g++ 12.2,
`-march=native` on an x86-64 CPU with FMA). The order inside a leaf differs
always, because the C++ split (`std::partition`) is not stable. A missing
compiler or a failed compile raises and builds no tree.
"""
import os
import time
import types

import numpy as np
import pytest
import torch

from rlshaders_tpu.accel import bvh as JB
from rlshaders_tpu.accel import native as jnative
from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.parallel import mesh as jmesh
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.accel import bvh as TB
from rlshaders_tpu_torch.accel import native
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene import demo as tdemo
from tools.make_dense_disney import dense_nodes

cpu_math.settle()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(f for f in os.listdir(os.path.join(REPO, "scenes"))
                if f.endswith(".ass"))
NODE_FIELDS = ("bbox_min", "bbox_max", "first", "count", "miss")


def load_jax_native() -> None:
    """Load the JAX package's native builder. It compiles its library in
    place, so a process that loads it while another one writes it finds
    a partial file and falls back to NumPy for good; load again until the
    file is whole."""
    for _ in range(40):
        if jnative.available():
            return
        jnative._tried = False
        time.sleep(0.5)
    pytest.fail("the JAX package's native builder does not load")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    load_jax_native()


def soup(t, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    return v0, e1, e2


def assert_jax_default(arrays, jtree) -> None:
    for f, a in zip(JB.BVH._fields, arrays):
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(getattr(jtree, f)),
                                      err_msg=f)


def leaf_sets(first, count, order) -> list:
    order = np.asarray(order)
    return [frozenset(order[f:f + c].tolist())
            for f, c in zip(np.asarray(first), np.asarray(count)) if f >= 0]


def assert_same_nodes_and_leaves(a, b) -> None:
    for f, x, y in zip(NODE_FIELDS, a, b):
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert leaf_sets(a[2], a[3], a[5]) == leaf_sets(b[2], b[3], b[5])


@pytest.mark.parametrize("t,seed", [(7, 3), (600, 0), (2000, 5),
                                    (100_000, 2)])
def test_native_equals_jax_default(t, seed):
    v0, e1, e2 = soup(t, seed)
    assert_jax_default(native.build_arrays(v0, e1, e2), JB.build(v0, e1, e2))


def test_dense_disney_soup_equals_jax_default():
    g = tbuild.build(dense_nodes(), device="cpu").geometry
    v0, e1, e2 = g.v0.numpy(), g.e1.numpy(), g.e2.numpy()
    assert v0.shape == (1_572_866, 3)
    arrays = native.build_arrays(v0, e1, e2)
    assert_jax_default(arrays, JB.build(v0, e1, e2))
    assert arrays[0].shape[0] > 900_000


@pytest.mark.parametrize("t,seed", [(7, 3), (600, 0), (2000, 5)])
def test_plain_builder_same_nodes_and_leaves(t, seed):
    v0, e1, e2 = soup(t, seed)
    nat = native.build_arrays(v0, e1, e2)
    plain = TB.build_arrays(v0, e1, e2)
    assert_same_nodes_and_leaves(nat, plain)
    if t >= 600:   # the orders inside the leaves differ
        assert not np.array_equal(nat[5], plain[5])


def test_plain_builder_is_the_uncontracted_native_builder():
    """The dense copy's splits nearly tie; without fused multiply-adds the
    native builder rounds the SAH cost as the plain one does."""
    g = tbuild.build(dense_nodes(64), device="cpu").geometry
    tris = g.v0.numpy(), g.e1.numpy(), g.e2.numpy()
    exact = native.build_arrays(*tris, flags=native.EXACT_FLAGS)
    assert_same_nodes_and_leaves(exact, TB.build_arrays(*tris))
    assert exact[0].shape[0] == 14_535


def _scene(name):
    if name.startswith("demo"):
        skin = name == "demo_skin"
        jscene, _ = jmesh.demo_scene(skin=skin)
        return jscene, tdemo.demo_scene(skin=skin, device="cpu")[0]
    path = os.path.join(REPO, "scenes", name)
    return jbuild.build(path), tbuild.build(path, device="cpu")


@pytest.mark.parametrize("name", ["demo", "demo_skin", *SCENES])
def test_trace_build_equals_jax(name):
    """`trace.build` of each scene equals the JAX package's, and the JAX
    accel carried across by interop equals the port's own, table for
    table."""
    js, ts = _scene(name)
    ja = jtrace.build(js.geometry)
    own = ttrace.build(ts.geometry)
    assert_jax_default([getattr(own.tree, f).numpy()
                        for f in JB.BVH._fields], ja.tree)
    _, via = interop.scene_from_numpy(interop.scene_tables(js, ja), "cpu")
    for part in ("tree", "tris"):
        a, b = getattr(own, part), getattr(via, part)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (part, f)
    for f in ("nodes", "tris", "cut"):
        assert torch.equal(getattr(own.packed, f), getattr(via.packed, f)), f
    assert own.packed.path == via.packed.path


def _geometry(t):
    v0, e1, e2 = soup(t, 1)
    return types.SimpleNamespace(
        v0=torch.tensor(v0), e1=torch.tensor(e1), e2=torch.tensor(e2),
        visibility=torch.full((t,), 255, dtype=torch.int32),
        opaque=torch.ones(t, dtype=torch.bool))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "CXX", "rls-no-such-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="rls-no-such-compiler not found"):
        ttrace.build(_geometry(50))
    assert not build_dir.exists()


def test_failed_compile_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "accel.cpp"
    src.write_text('extern "C" int rls_build_bvh( { return 0; }\n')
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="error"):
        ttrace.build(_geometry(50))
    assert os.listdir(build_dir) == []


def test_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    """One library per source: a second build finds it, an edited source
    builds another."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    first = native.build()
    assert native.build() == first
    src = tmp_path / "accel.cpp"
    with open(native.SOURCE) as f:
        src.write_text(f.read() + "// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    second = native.build()
    assert second != first
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["accel.cpp", os.path.basename(first), os.path.basename(second)])
