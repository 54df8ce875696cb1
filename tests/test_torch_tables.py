"""The port's constant tables against the JAX package's, and the port's
import boundary.

Ziria has no weights; its constant tables play their part (see
ziria_tpu_torch/tables.py). The port rebuilds every one with numpy, so
this file pins each, by its JAX name, equal to the reference's array.
"""

import ast
import os

import numpy as np
import pytest

from ziria_tpu.ops import coding, cplx, crc, demap, interleave, modulate, \
    ofdm, scramble, viterbi
from ziria_tpu_torch.tables import reference_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODS = {"coding": coding, "cplx": cplx, "crc": crc, "demap": demap,
         "interleave": interleave, "modulate": modulate, "ofdm": ofdm,
         "scramble": scramble, "viterbi": viterbi}

TABLES = reference_tables()


def _jax_value(key: str):
    """Evaluate a reference_tables key ("ops.<module>.<expr>") against
    the JAX package's module of that name."""
    _ops, mod, expr = key.split(".", 2)
    return eval(expr, {}, vars(_MODS[mod]))


def test_table_set_covers_the_receive_path():
    # trellis, taps, DFT, preamble/LTS/STS, pilots, interleaver,
    # puncturing, demap scale, CRC and scrambler tables all present
    for prefix in ("ops.viterbi._PRED", "ops.coding.G0",
                   "ops.cplx._dft_mats", "ops.ofdm._PREAMBLE",
                   "ops.ofdm.PILOT_POLARITY", "ops.interleave.",
                   "ops.coding.PUNCTURE_KEEP", "ops.demap._NORM",
                   "ops.crc._TABLE", "ops.scramble._SEED_TABLE"):
        assert any(k.startswith(prefix) for k in TABLES), prefix


@pytest.mark.parametrize("key", sorted(TABLES))
def test_table_equals_reference(key):
    want = np.asarray(_jax_value(key))
    got = np.asarray(TABLES[key])
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _port_files():
    pkg = os.path.join(ROOT, "ziria_tpu_torch")
    for d, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ziria_tpu"), \
                f"{path}:{node.lineno} imports {name}"
