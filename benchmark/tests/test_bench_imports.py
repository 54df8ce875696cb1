"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level names (the port's name begins with the JAX
package's); the reference and the traffic import nothing of the port."""

import ast
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "ziria_tpu"}
PORTLESS = ("reference", "generator.py", "traffic")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _sub, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_and_a_portless_yardstick():
    seen = 0
    for path in _sources():
        rel = os.path.relpath(path, HERE)
        names = set(_imports(path))
        assert not names & FORBIDDEN, (rel, names & FORBIDDEN)
        if rel.startswith(PORTLESS):
            assert "ziria_tpu_torch" not in names, rel
        seen += 1
    assert seen > 10


def test_names_are_compared_whole():
    assert "ziria_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ziria_tpu.ops".split(".")[0] in FORBIDDEN
