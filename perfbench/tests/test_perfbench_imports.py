"""Nothing a run holds, and nothing the reference imports, is JAX, the JAX
package or (for the reference) the port: top-level module names compared
whole, so multiprime_tpu_torch is not multiprime_tpu."""

import ast
import json
import os
import subprocess
import sys

from perfbench.harness import FORBIDDEN, PKG, ROOT

CHILD = r"""
import json, sys, tempfile
sys.path.insert(0, %(root)r)
from perfbench.tests import tiny
tmp = tempfile.mkdtemp()
result, _, _ = tiny.run(tmp, %(cell)r)
print(json.dumps({"correct": result["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax_and_no_jax_package():
    for cell in ("tiny.host", "tiny.spec"):
        out = subprocess.run([sys.executable, "-c", CHILD % {
            "root": ROOT, "cell": cell}], capture_output=True, text=True,
            cwd=ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["correct"]
        assert not set(got["modules"]) & set(FORBIDDEN)
        assert "multiprime_tpu_torch" in got["modules"]


def test_sources_import_no_jax_and_reference_imports_no_port():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mods = set(_imports(path))
            assert not mods & set(FORBIDDEN), path
            if os.path.basename(dirpath) == "reference":
                assert "multiprime_tpu_torch" not in mods, path
