"""PyTorch/CUDA port of the ziria_tpu 802.11a receive path.

The JAX package ``ziria_tpu`` is the reference; this package mirrors its
module names (``ops/``, ``phy/wifi/``, ``backend/``, ``utils/``) so each
function has an obvious counterpart there. It imports ``torch`` and
numpy only: never ``jax`` and nothing of ``ziria_tpu``, whose constant
tables it rebuilds itself (``tables.reference_tables`` lists them under
their JAX names for the parity tests).

Conventions kept from the reference at every public function: complex
samples are ``(..., 2)`` float32 re/im pairs, bits are uint8 0/1.
Where the reference used ``vmap``, the batch dimension is written out
and comes first. Entry points take ``device=`` and default to
``"cuda"``; a kernel wrapper runs its plain PyTorch version only for a
tensor that lies on the CPU, and on a CUDA tensor launches its
hand-written kernel (``csrc/``) or raises.
"""
