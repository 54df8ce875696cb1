"""Lexer for the Ziria-style surface syntax (port copy of
ziria_tpu/frontend/lexer.py, which imports no JAX).

Counterpart of the reference's `BlinkLexer` (SURVEY.md §2.1). Hand-rolled
maximal-munch scanner — no generator dependency — producing a flat token
list the recursive-descent parser (frontend/parser.py) walks.

Lexical syntax:
  - line comments: ``--`` (reference style) and ``//``; block ``{- -}``
  - bit literals ``'0`` / ``'1``; ints (decimal, ``0x`` hex); floats
    (``1.5``, ``2e-3``); double-quoted strings (print/error args)
  - multi-char operators, longest match first: ``|>>>|  >>>  :=  <-
    ==  !=  <=  >=  <<  >>  &&  ||  **``
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

KEYWORDS = frozenset({
    "fun", "comp", "let", "var", "ext", "struct", "in",
    "take", "takes", "emit", "emits", "return", "do", "seq",
    "repeat", "map", "if", "then", "else", "for", "while", "until",
    "times", "read", "write", "true", "false", "not",
    "print", "println", "error",
    # type names are keywords too (they double as cast functions)
    "bit", "bool", "int", "int8", "int16", "int32", "int64",
    "double", "complex", "complex16", "complex32", "arr",
})

# longest-match-first operator/punct table
_OPS = (
    "|>>>|", ">>>",
    ":=", "<-", "==", "!=", "<=", ">=", "<<", ">>", "&&", "||", "**",
    "(", ")", "[", "]", "{", "}", ",", ";", ":", ".",
    "+", "-", "*", "/", "%", "<", ">", "=", "&", "|", "^", "~", "!",
)


@dataclass(frozen=True)
class Token:
    kind: str          # 'id' | 'kw' | 'int' | 'float' | 'bit' | 'str'
                       # | 'op' | 'eof'
    text: str
    line: int
    col: int

    @property
    def loc(self) -> Tuple[int, int]:
        return (self.line, self.col)

    def __repr__(self):
        return f"{self.kind}({self.text!r})@{self.line}:{self.col}"


class LexError(SyntaxError):
    pass


def _err(src_name: str, line: int, col: int, msg: str) -> LexError:
    return LexError(f"{src_name}:{line}:{col}: {msg}")


def tokenize(src: str, src_name: str = "<input>") -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(src)
    line, col = 1, 1

    def advance(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n":
            advance(1)
            continue
        # comments
        if src.startswith("--", i) or src.startswith("//", i):
            j = src.find("\n", i)
            advance((j if j >= 0 else n) - i)
            continue
        if src.startswith("{-", i):
            depth, j = 1, i + 2
            while j < n and depth:
                if src.startswith("{-", j):
                    depth += 1
                    j += 2
                elif src.startswith("-}", j):
                    depth -= 1
                    j += 2
                else:
                    j += 1
            if depth:
                raise _err(src_name, line, col, "unterminated {- comment")
            advance(j - i)
            continue
        # bit literal
        if c == "'" and i + 1 < n and src[i + 1] in "01":
            toks.append(Token("bit", src[i + 1], line, col))
            advance(2)
            continue
        # string
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"',
                                "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise _err(src_name, line, col, "unterminated string")
            toks.append(Token("str", "".join(buf), line, col))
            advance(j + 1 - i)
            continue
        # numbers
        if c.isdigit():
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and (src[j].isdigit()
                                 or src[j].lower() in "abcdef"):
                    j += 1
                if j == i + 2:
                    raise _err(src_name, line, col,
                               "hex literal needs digits after 0x")
                toks.append(Token("int", src[i:j], line, col))
                advance(j - i)
                continue
            while j < n and src[j].isdigit():
                j += 1
            is_float = False
            # a '.' is part of the number only if a digit follows
            # (so `0..` or `x.f` stay separate tokens)
            if j < n and src[j] == "." and j + 1 < n and src[j + 1].isdigit():
                is_float = True
                j += 1
                while j < n and src[j].isdigit():
                    j += 1
            if j < n and src[j] in "eE":
                k = j + 1
                if k < n and src[k] in "+-":
                    k += 1
                if k < n and src[k].isdigit():
                    is_float = True
                    j = k
                    while j < n and src[j].isdigit():
                        j += 1
            toks.append(Token("float" if is_float else "int",
                              src[i:j], line, col))
            advance(j - i)
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_'"):
                j += 1
            word = src[i:j]
            toks.append(Token("kw" if word in KEYWORDS else "id",
                              word, line, col))
            advance(j - i)
            continue
        # operators / punctuation
        for op in _OPS:
            if src.startswith(op, i):
                toks.append(Token("op", op, line, col))
                advance(len(op))
                break
        else:
            raise _err(src_name, line, col, f"unexpected character {c!r}")

    toks.append(Token("eof", "", line, col))
    return toks
