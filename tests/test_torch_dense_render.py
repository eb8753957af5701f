"""The dense Disney scene (tools/make_dense_disney.py) reduced to 64 x 32
quads a ball (24,578 triangles, whose kernel tables exceed TABLE_ROOM: on
the card they take the global path) at 16x16, AA 1, one diffuse and one
glossy sample a hit, rendered by the JAX package and by the port on the
CPU, every plane, through the port's own build and through interop; and
the generator itself against scenes/disney_spheres.ass.

Measured: every pixel of every plane within 4.1e-7 of the JAX frame
(RGBA 4.02e-7, indirect_diffuse 3.87e-7, the direct and glossy planes
1.2e-7-1.4e-7), through both the port's build and interop (the two port
frames are equal: the trees are). The tolerances are the Disney frame's
(tests/test_torch_disney_render.py, the refraction slice's).
"""
import numpy as np
import pytest

from rlshaders_tpu.accel import trace as jtrace
from rlshaders_tpu.integrator import wavefront as jwave
from rlshaders_tpu.scene import build as jbuild
from test_torch_native_bvh import load_jax_native
from test_torch_refract import PLANES, frames_agree
from rlshaders_tpu_torch import interop
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.core import cpu_math
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.ops import intersect as kernels
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.scene.ass_parser import parse
from tools.make_dense_disney import DISNEY, dense_nodes, triangles

cpu_math.settle()

AROUND = 64
RES = 16
KW = dict(seed=0, aa_samples=1, xres=RES, yres=RES)


def reduced_nodes():
    nodes = dense_nodes(AROUND)
    opts = next(n for n in nodes if n.type == "options")
    opts.params.update(GI_diffuse_samples=1, GI_glossy_samples=1)
    return nodes


@pytest.fixture(scope="module")
def frames():
    load_jax_native()
    nodes = reduced_nodes()
    js = jbuild.build(nodes)
    ja = jtrace.build(js.geometry)
    jout = jwave.render(js, ja, **KW)
    ts = tbuild.build(nodes, device="cpu")
    accel = ttrace.build(ts.geometry)
    own = twave.render(ts, accel, **KW)
    iscene, iaccel = interop.scene_from_numpy(interop.scene_tables(js, ja),
                                              "cpu")
    via = twave.render(iscene, iaccel, **KW)
    return jout, own, via, accel


@pytest.mark.parametrize("name", PLANES)
def test_dense_frame_matches_jax(frames, name):
    jout, own, via, _ = frames
    frames_agree(own, jout, name, RES)
    frames_agree(via, jout, name, RES)
    np.testing.assert_array_equal(own[name].numpy(), via[name].numpy())


def test_dense_frame_tables_take_the_global_path(frames):
    *_, accel = frames
    assert accel.tree.tri_order.shape[0] == 24_578
    assert accel.packed.path == "global"
    assert (accel.packed.nodes.numel() * 4 + accel.packed.tris.numel() * 4
            > kernels.TABLE_ROOM)


def test_generator_keeps_the_scene():
    """At the file's own 20 x 10 quads the generator gives the file's
    balls (to its six printed digits); at any size every other node is
    the file's."""
    orig = parse(DISNEY)
    again = dense_nodes(20)
    assert [n.name for n in again] == [n.name for n in orig]
    for a, o in zip(again, orig):
        assert a.type == o.type and a.params.keys() == o.params.keys()
        for k, v in o.params.items():
            if a.name.startswith("ball_") and k in ("vlist", "nlist"):
                np.testing.assert_allclose(a.get(k), v, atol=5e-6)
            else:
                np.testing.assert_array_equal(a.get(k), v, err_msg=k)
    assert triangles(again) == 2_402
    dense = reduced_nodes()
    assert triangles(dense) == 2 + 6 * 2 * AROUND * (AROUND // 2)
    for a, o in zip(dense, orig):
        if not a.name.startswith("ball_") and a.type != "options":
            for k, v in o.params.items():
                np.testing.assert_array_equal(a.get(k), v, err_msg=k)
