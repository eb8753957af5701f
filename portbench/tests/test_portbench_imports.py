"""What the benchmark imports: never JAX or the JAX package, and the
reference nothing of the program. Top-level module names are compared
whole: the port's name, rlshaders_tpu_torch, starts with the JAX
package's."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "rlshaders_tpu"}


def loaded_after(code: str) -> set:
    """Top-level names of every module loaded by `code` in a fresh
    interpreter."""
    prog = (f"import sys\nsys.path[:0] = [{str(ROOT)!r}, "
            f"{str(BENCH / 'reference')!r}]\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_import_no_jax():
    code = ("from portbench import harness, check, roofline, control, "
            "lowprec\n"
            "import portbench.run\n"
            "for n in __import__('os').listdir('portbench/metrics'):\n"
            "    if n.endswith('.py'):\n"
            "        harness.reader(n[:-3])\n"
            "from rlshaders_tpu_torch.integrator import wavefront, sss\n"
            "from rlshaders_tpu_torch.parallel import mesh\n"
            "from rlshaders_tpu_torch.scene import build\n"
            "from rlshaders_tpu_torch.accel import trace\n")
    names = loaded_after(code)
    assert "rlshaders_tpu_torch" in names
    assert not names & JAX, names & JAX


def test_reference_imports_nothing_of_the_program():
    mods = sorted(
        "rlsref." + p.relative_to(BENCH / "reference" / "rlsref")
        .with_suffix("").as_posix().replace("/", ".")
        for p in (BENCH / "reference" / "rlsref").rglob("*.py")
        if p.name != "__init__.py")
    names = loaded_after("\n".join(f"import {m}" for m in mods))
    assert "rlsref" in names
    assert not names & (JAX | {"rlshaders_tpu_torch", "portbench"})


def test_no_source_under_the_benchmark_names_jax():
    """A static look as well: no import statement under portbench names
    JAX or the JAX package, and none under the reference the program."""
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & JAX, (path, tops)
            if "reference" in path.parts:
                assert "rlshaders_tpu_torch" not in tops, (path, tops)
                assert "portbench" not in tops, (path, tops)
