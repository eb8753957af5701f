"""The port's verbatim copies of jax-free JAX modules, held equal to their
originals: models/registry.py, models/dcc.py and utils/watermark.py with
its pinned mask utils/wm_mask_256.bits (byte for byte).

The copies differ from the originals only by the note that says why they
are copies. No import line differs: each original imports only relative
to its package (`..scene.build`, `.registry`, `..io`), which in the copy
resolves to the port's module of the same name. The registry reads the
`MAT_*` codes from the port's scene/build.py, which a test holds equal to
the JAX build's.
"""
import hashlib
import os

import numpy as np
import pytest

from rlshaders_tpu.models import dcc as jdcc
from rlshaders_tpu.models import registry as jreg
from rlshaders_tpu.scene import build as jbuild
from rlshaders_tpu.utils import watermark as jwm
from rlshaders_tpu_torch.models import dcc as tdcc
from rlshaders_tpu_torch.models import registry as treg
from rlshaders_tpu_torch.scene import build as tbuild
from rlshaders_tpu_torch.utils import watermark as twm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rel", ["models/registry.py", "models/dcc.py",
                                 "utils/watermark.py"])
def test_copy_is_verbatim(rel):
    with open(os.path.join(REPO, "rlshaders_tpu", rel)) as f:
        orig = f.read()
    with open(os.path.join(REPO, "rlshaders_tpu_torch", rel)) as f:
        copy = f.read()
    note = ("\n\nCopied verbatim from rlshaders_tpu/%s: importing any\n"
            "module of rlshaders_tpu imports jax, which the torch port must "
            "not need." % rel)
    assert note in copy
    assert copy.replace(note, "") == orig


def test_mask_bits_are_the_same_bytes():
    def read(pkg):
        with open(os.path.join(REPO, pkg, "utils", "wm_mask_256.bits"),
                  "rb") as f:
            return f.read()

    assert read("rlshaders_tpu_torch") == read("rlshaders_tpu")
    m = twm.pinned_mask()
    assert hashlib.sha256(m.tobytes()).hexdigest() == twm.PINNED_SHA256
    assert m.mean() == pytest.approx(twm.PINNED_COVERAGE, abs=1e-9)
    np.testing.assert_array_equal(m, jwm.pinned_mask())


def test_watermark_mask_needs_the_goldens(tmp_path):
    assert twm.watermark_mask(str(tmp_path)) is None


@pytest.mark.parametrize("name", ["MAT_STANDARD", "MAT_GGX", "MAT_DISNEY",
                                  "MAT_SKIN"])
def test_material_codes_equal_jax(name):
    assert getattr(tbuild, name) == getattr(jbuild, name)


def test_registry_equals_jax():
    assert list(treg.SHADERS) == list(jreg.SHADERS)
    for name, spec in treg.SHADERS.items():
        assert repr(spec) == repr(jreg.SHADERS[name])


def test_dcc_generators_equal_jax():
    assert tdcc.generate_mtd() == jdcc.generate_mtd()
    for name, spec in treg.SHADERS.items():
        if spec.maya_id is not None:
            assert (tdcc.generate_ae_template(spec)
                    == jdcc.generate_ae_template(jreg.SHADERS[name]))
