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
    ofdm, scramble, viterbi, viterbi_pallas
from ziria_tpu_torch.tables import reference_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODS = {"coding": coding, "cplx": cplx, "crc": crc, "demap": demap,
         "interleave": interleave, "modulate": modulate, "ofdm": ofdm,
         "scramble": scramble, "viterbi": viterbi,
         "viterbi_pallas": viterbi_pallas}

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
                   "ops.crc._TABLE", "ops.scramble._SEED_TABLE",
                   "ops.demap.demap_bit_layout",
                   "ops.interleave.deinterleave_slots",
                   "ops.viterbi_pallas._front_tables",
                   "ops.viterbi_pallas.mixed_front_tables"):
        assert any(k.startswith(prefix) for k in TABLES), prefix


def test_fused_tables_cover_every_rate():
    # every rate's known-rate slot tables, both banks of the mixed
    # front, and the per-bit and per-slot descriptors they come from
    assert sum(k.startswith("ops.viterbi_pallas._front_tables(")
               for k in TABLES) == 8 * 3
    assert sum(k.startswith("ops.demap.demap_bit_layout(")
               for k in TABLES) == 4 * 3
    assert sum(k.startswith("ops.interleave.deinterleave_slots(")
               for k in TABLES) == 4 * 2
    assert "ops.viterbi_pallas.mixed_front_tables()[0]" in TABLES
    assert "ops.viterbi_pallas.mixed_front_tables()[1]" in TABLES


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
