"""No module that the harness or the reference imports is of the JAX stack
or the JAX package (top-level names compared whole), and the reference
imports nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "heligym_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_names_a_forbidden_module():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "heligym_tpu_torch", (path, name)


def test_loaded_modules_after_a_run():
    """In a fresh process: the reference alone loads no module of the port;
    a whole tiny run of every cell loads none of the JAX stack's (the
    port's `heligym_tpu_torch` is not `heligym_tpu`: whole names)."""
    code = f"""
import sys
sys.path[:0] = [{HERE!r}, {ROOT!r}]
from reference import check, learner
from reference.sim import env
tops = {{m.split('.')[0] for m in sys.modules}}
assert 'heligym_tpu_torch' not in tops, sorted(tops)
from harness import runner, spec
sys.path.insert(0, {os.path.join(HERE, 'tests')!r})
from conftest import TINY
for w in sorted(TINY):
    runner.run(spec.cell(w), 11, 0.1, False, 'cpu', 0.0, overrides=TINY[w], log=lambda m: None)
assert 'heligym_tpu_torch' in {{m.split('.')[0] for m in sys.modules}}
print(runner.forbidden_modules())
"""
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
