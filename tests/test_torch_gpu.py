"""Tests of the port that need a CUDA card (marker `gpu`); they skip here.

This file imports neither jax nor the JAX package, so it runs on a machine
without them. Run it on the card without the repository's conftest.py
(which imports jax):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The kernels must equal their plain versions exactly (the .cu file builds
with -fmad=false and repeats the plain walk's order of operations). The
CUDA render is held to the CPU render with chip_smoke.py's tolerance.
"""
import types

import numpy as np
import pytest
import torch

from rlshaders_tpu_torch.accel import bvh
from rlshaders_tpu_torch.accel import trace


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _soup_accel(device, t=900, seed=3):
    rs = np.random.default_rng(seed)
    geom = types.SimpleNamespace(
        v0=torch.tensor(rs.uniform(-1, 1, (t, 3)), dtype=torch.float32),
        e1=torch.tensor(rs.uniform(-0.3, 0.3, (t, 3)), dtype=torch.float32),
        e2=torch.tensor(rs.uniform(-0.3, 0.3, (t, 3)), dtype=torch.float32),
        visibility=torch.tensor(np.where(rs.random(t) < 0.5, 2, 3),
                                dtype=torch.int32),
        opaque=torch.tensor(rs.random(t) < 0.7),
    )
    geom = types.SimpleNamespace(**{k: v.to(device)
                                    for k, v in vars(geom).items()})
    return trace.build(geom)


@pytest.mark.gpu
def test_kernels_match_plain_walk(cuda_device):
    from rlshaders_tpu_torch.ops import intersect as kernels

    acc = _soup_accel(cuda_device)
    rs = np.random.default_rng(4)
    n = 20000
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = [0.0, -1.0, 0.0]
    d[:8, 0] = -0.0
    t_max = rs.uniform(-0.5, 3.0, n)
    t_max[:100] = 1e30
    ex = np.where(rs.random(n) < 0.3, rs.integers(0, 900, n), -1)
    args = [torch.tensor(a, dtype=dt, device=cuda_device) for a, dt in (
        (rs.uniform(-2, 2, (n, 3)), torch.float32), (d, torch.float32),
        (t_max, torch.float32), (ex, torch.int32))]
    before = dict(kernels.LAUNCHES)
    for vis_mask in (1, 2, 3, 4):
        hk = kernels.nearest(acc.tree, acc.tris, *args, vis_mask)
        hp = bvh.intersect(acc.tree, acc.tris, *args, vis_mask)
        for a, b in zip(hk, hp):
            assert torch.equal(a, b)
        bk = kernels.occluded(acc.tree, acc.tris, *args, vis_mask)
        bp = bvh.occluded(acc.tree, acc.tris, *args, vis_mask)
        assert torch.equal(bk, bp)
    assert kernels.LAUNCHES["rls_nearest"] == before["rls_nearest"] + 4
    assert kernels.LAUNCHES["rls_occluded"] == before["rls_occluded"] + 4


@pytest.mark.gpu
def test_wrapper_refuses_bad_inputs(cuda_device):
    from rlshaders_tpu_torch.ops import intersect as kernels

    acc = _soup_accel(cuda_device)
    o = torch.zeros((4, 3), device=cuda_device)
    d = torch.ones((4, 3), device=cuda_device)
    tm = torch.ones(4, device=cuda_device)
    ex = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.nearest(acc.tree, acc.tris, o, d, tm, ex.long(), 1)
    with pytest.raises(ValueError):
        kernels.nearest(acc.tree, acc.tris, o.cpu(), d, tm, ex, 1)
    with pytest.raises(ValueError):
        kernels.occluded(acc.tree, acc.tris, o, d.t().contiguous().t(), tm,
                         ex, 1)


@pytest.mark.gpu
def test_cuda_render_matches_cpu_render(cuda_device):
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.scene.demo import demo_scene

    out = {}
    for dev in (cuda_device, "cpu"):
        scene, accel = demo_scene(skin=False, device=dev)
        out[str(dev)] = wavefront.render(scene, accel, device=dev, seed=0,
                                         aa_samples=2, xres=32, yres=32)
    a, b = out["cuda"]["RGBA"].cpu().numpy(), out["cpu"]["RGBA"].numpy()
    assert (np.abs(a - b).max(-1) <= 1e-3).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 2e-3 * abs(b.mean())
    assert out["cuda"]["__stats__"] == out["cpu"]["__stats__"]
