"""The SSS stage of the port on the analytic scenes of
tests/test_integrator.py, with that file's scene strings and expected
values: the `standard` Ksss furnace (albedo * L_sky * STD_SSS_ENERGY), the
rlSkin Burley furnace (albedo * L_sky * 0.7117), the Ksss plane under a
small quad light, and a probe-visible foreign plane that ends the probes.
"""
import os

import numpy as np
import pytest

from test_integrator import (
    SCENE_SSS_FOREIGN_BLOCKER, SCENE_SSS_FURNACE, SCENE_SSS_FURNACE_SKIN,
    SCENE_SSS_QUAD,
)
from rlshaders_tpu_torch.accel import trace as ttrace
from rlshaders_tpu_torch.integrator import wavefront as twave
from rlshaders_tpu_torch.integrator.sss import STD_SSS_ENERGY
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.core import cpu_math

cpu_math.settle()


def _center(scene_text, tmp_path):
    p = os.path.join(str(tmp_path), "scene.ass")
    with open(p, "w") as f:
        f.write(scene_text)
    scene = tbuild.build(p, device="cpu")
    out = twave.render(scene, ttrace.build(scene.geometry), tile_pixels=512)
    img = out["RGBA"].numpy()
    assert np.isfinite(img).all()
    # the center pixels view the plane straight on
    return float(img[6:10, 6:10].mean()), out


def test_sss_furnace_energy(tmp_path):
    val, out = _center(SCENE_SSS_FURNACE, tmp_path)
    expected = 1.0 * 0.3 * STD_SSS_ENERGY
    assert abs(val - expected) / expected < 0.10, (val, expected)
    assert float(out["sss"].mean()) > 0.0


def test_sss_furnace_energy_skin_burley(tmp_path):
    val, _ = _center(SCENE_SSS_FURNACE_SKIN, tmp_path)
    expected = 1.0 * 0.3 * 0.7117
    assert abs(val - expected) / expected < 0.10, (val, expected)


def test_sss_quad_light_energy(tmp_path):
    val, _ = _center(SCENE_SSS_QUAD, tmp_path)
    expected = (1.0 / np.pi) * STD_SSS_ENERGY
    assert abs(val - expected) / expected < 0.12, (val, expected)


def test_sss_probe_terminates_at_foreign_hit(tmp_path):
    val, _ = _center(SCENE_SSS_FOREIGN_BLOCKER, tmp_path)
    unblocked = 0.3 * 0.7117
    assert val < 0.3 * unblocked, (val, unblocked)
    assert val > 0.01 * unblocked, (val, unblocked)


def test_fitted_energy_is_the_jax_constant():
    from rlshaders_tpu.integrator import sss as jsss

    assert STD_SSS_ENERGY == jsss.STD_SSS_ENERGY
