"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
compared by whole top-level names, and the reference loads nothing of the
program."""
import ast
import os
import subprocess
import sys

from benchmark import harness, run

BLOCKER = r'''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "nnc_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [%r, %r]
import _tiny
line = _tiny.line("lego.frame")
assert line["correct"], line
import benchmark.run as run
assert run.forbidden_modules() == [], run.forbidden_modules()
print("ok")
'''


def test_a_run_loads_no_jax():
    code = BLOCKER % (harness.ROOT, os.path.dirname(__file__))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("nnc_tpu_torch", "nnc_tpu_torch.models", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, object())
    found = run.forbidden_modules()
    assert "nnc_tpu_torch" not in found and "jaxtyping" not in found
    monkeypatch.setitem(sys.modules, "nnc_tpu.render", object())
    assert "nnc_tpu" in run.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(harness.HERE, "reference", "nerf.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert {n.split(".")[0] for n in names} <= {"__future__", "contextlib",
                                                "math", "numpy", "torch"}
