"""PyTorch/CUDA port of ziria_tpu: the 802.11a library and the Ziria
compiler.

The JAX package ``ziria_tpu`` is the reference; this package mirrors its
module names (``core/``, ``frontend/``, ``interp/``, ``ops/``,
``phy/wifi/``, ``backend/``, ``runtime/``, ``utils/``) so each function
has an obvious counterpart there. ``python -m ziria_tpu_torch`` compiles
a ``.zir`` program and runs it (runtime/cli.py); the IR builders below
are the Python-embedded DSL, as in the reference's ``__init__``. It
imports ``torch`` and numpy only: never ``jax`` and nothing of
``ziria_tpu``, whose constant tables it rebuilds itself
(``tables.reference_tables`` lists them under their JAX names for the
parity tests).

Conventions kept from the reference at every public function: complex
samples are ``(..., 2)`` float32 re/im pairs, bits are uint8 0/1. Where
the reference used ``vmap``, the batch dimension is written out and
comes first. Entry points take ``device=`` and default to ``"cuda"``; a
kernel wrapper runs its plain PyTorch version only for a tensor that
lies on the CPU, and on a CUDA tensor launches its hand-written kernel
(``csrc/``) or raises.
"""

__version__ = "0.1.0"

from ziria_tpu_torch.core.ir import (  # noqa: F401,E402
    Comp,
    take,
    takes,
    emit,
    emit1,
    emits,
    ret,
    seq,
    let,
    let_ref,
    assign,
    zmap,
    map_accum,
    repeat,
    pipe,
    par_pipe,
    for_loop,
    while_loop,
    branch,
    jax_block,
)
from ziria_tpu_torch.core.card import Card, cardinality  # noqa: F401,E402
from ziria_tpu_torch.core.types import (  # noqa: F401,E402
    CTy,
    TTy,
    ZiriaTypeError,
    typecheck,
)
from ziria_tpu_torch.core.opt import fold, fold_with_stats  # noqa: F401,E402

#: exports whose modules import torch, loaded on first use so that
#: `python -m ziria_tpu_torch lint` runs without importing torch
_LAZY = {"autolut": "ziria_tpu_torch.core.autolut",
         "VectPlan": "ziria_tpu_torch.core.vectorize",
         "mitigator": "ziria_tpu_torch.core.vectorize",
         "vectorize": "ziria_tpu_torch.core.vectorize",
         "widen": "ziria_tpu_torch.core.vectorize"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
