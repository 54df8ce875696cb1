"""Textual frontend: Ziria-style surface syntax → core IR (port copy of
ziria_tpu/frontend/__init__.py, which imports no JAX).

The missing half of the reference's compiler stack (SURVEY.md §2.1
lexer/parser/typecheck): `.zir` source files with the two-level
language — first-order imperative expressions + stream computations
composed with take/emit/map/repeat/`>>>`/`|>>>|` — parse, typecheck,
and elaborate into the same core IR the Python-embedded DSL builds,
then run on either backend (`interp` oracle or fused `jit`).

    from ziria_tpu_torch.frontend import compile_source
    prog = compile_source('let comp main = read[int32] >>> '
                          'map incr >>> write[int32] '
                          'fun incr(x: int32): int32 { return x + 1 }')
    # prog.comp is a core-IR pipeline; prog.in_ty/out_ty drive the CLI
"""

from ziria_tpu_torch.frontend.elab import (CompiledProgram, ElabError,
                                           compile_file, compile_source)
from ziria_tpu_torch.frontend.eval import ZiriaRuntimeError
from ziria_tpu_torch.frontend.lexer import LexError, tokenize
from ziria_tpu_torch.frontend.parser import (ParseError, parse_comp,
                                             parse_expr, parse_program)
from ziria_tpu_torch.frontend.typecheck import ZiriaTypeError

__all__ = [
    "CompiledProgram", "ElabError", "LexError", "ParseError",
    "ZiriaRuntimeError", "ZiriaTypeError", "compile_file",
    "compile_source", "parse_comp", "parse_expr", "parse_program",
    "tokenize",
]
