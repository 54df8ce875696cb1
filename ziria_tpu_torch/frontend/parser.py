"""Recursive-descent parser for the Ziria-style surface syntax (port copy of
ziria_tpu/frontend/parser.py, which imports no JAX).

Counterpart of the reference's `BlinkParseComp.hs`/`BlinkParseExpr.hs`
(SURVEY.md §2.1), hand-rolled instead of Parsec. Two-level grammar:

Top level::

    fun comp NAME(params) { C }        -- computation function
    fun NAME(params) [: ty] { stmts }  -- expression function
    let comp NAME = C                  -- computation binding (main!)
    let NAME = E                       -- constant
    ext fun NAME(params) : ty          -- external binding
    struct NAME = { f: ty; ... }

Computations (C), loosest-binding first::

    C  := S ( '>>>' S | '|>>>|' S )*
    S  := '{' item* '}' | 'seq' '{' item* '}' | atom
    item := [NAME | '(' NAME ':' ty ')'] '<-' C ';'
          | 'var' NAME ':' ty [':=' E] ';'
          | 'let' 'comp' NAME '=' C ';'
          | 'let' NAME '=' E ';'
          | C ';'
    atom := take | takes E | emit E | emits E | return E | do '{' stmts '}'
          | repeat S | map NAME | if E then S [else S]
          | for NAME in '[' E ',' E ']' S | times E S
          | while '(' E ')' S | do S until '(' E ')'
          | read ['[' ty ']'] | write ['[' ty ']']
          | NAME ['(' E,* ')'] | '(' C ')'

Expressions (E) are C-precedence with Ziria extras: bit literals
``'0/'1``, array literals ``{a, b}``, slices ``x[i,n]``, casts via
type-name calls (``int16(e)``), ``if E then E else E``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ziria_tpu_torch.frontend import ast as A
from ziria_tpu_torch.frontend.lexer import Token, tokenize

_BASE_TYPES = ("bit", "bool", "int", "int8", "int16", "int32", "int64",
               "double", "complex", "complex16", "complex32")

# binary operator precedence (higher binds tighter); all left-assoc
_BINOPS = {
    "||": 1, "&&": 2,
    "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6,
    "<": 7, "<=": 7, ">": 7, ">=": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
    "**": 11,
}


class ParseError(SyntaxError):
    pass


class Parser:
    def __init__(self, src: str, src_name: str = "<input>"):
        self.toks: List[Token] = tokenize(src, src_name)
        self.pos = 0
        self.src_name = src_name

    # ------------------------------------------------------------- plumbing

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self.pos += 1
        return t

    def at(self, kind: str, text: Optional[str] = None, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == kind and (text is None or t.text == text)

    def at_kw(self, *words: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == "kw" and t.text in words

    def at_op(self, *ops: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == "op" and t.text in ops

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.peek()
        if t.kind != kind or (text is not None and t.text != text):
            want = text or kind
            raise self.err(f"expected {want!r}, got {t.text or t.kind!r}")
        return self.next()

    def err(self, msg: str) -> ParseError:
        t = self.peek()
        return ParseError(f"{self.src_name}:{t.line}:{t.col}: {msg}")

    def _skip_semis(self) -> None:
        while self.at_op(";"):
            self.next()

    # ------------------------------------------------------------- types

    def parse_type(self) -> A.Ty:
        t = self.peek()
        if t.kind == "kw" and t.text in _BASE_TYPES:
            self.next()
            return A.TBase(t.text)
        if t.kind == "kw" and t.text == "arr":
            self.next()
            n = None
            if self.at_op("["):
                self.next()
                n = self.parse_expr()
                self.expect("op", "]")
            elem = self.parse_type()
            return A.TArr(n, elem)
        if t.kind == "id":
            self.next()
            return A.TStruct(t.text)
        raise self.err(f"expected a type, got {t.text!r}")

    # ------------------------------------------------------------- exprs

    def parse_expr(self) -> A.Expr:
        if self.at_kw("if"):
            loc = self.next().loc
            c = self.parse_expr()
            self.expect("kw", "then")
            a = self.parse_expr()
            self.expect("kw", "else")
            b = self.parse_expr()
            return A.ECond(loc, c, a, b)
        return self._bin_expr(0)

    def _bin_expr(self, min_prec: int) -> A.Expr:
        lhs = self._unary()
        while True:
            t = self.peek()
            if t.kind != "op" or t.text not in _BINOPS:
                break
            prec = _BINOPS[t.text]
            if prec < min_prec:
                break
            self.next()
            # left-assoc: parse rhs at prec+1
            rhs = self._bin_expr(prec + 1)
            lhs = A.EBin(t.loc, t.text, lhs, rhs)
        return lhs

    def _unary(self) -> A.Expr:
        t = self.peek()
        if self.at_op("-", "~", "!"):
            self.next()
            return A.EUn(t.loc, t.text, self._unary())
        if self.at_kw("not"):
            self.next()
            return A.EUn(t.loc, "!", self._unary())
        return self._postfix(self._atom())

    def _postfix(self, e: A.Expr) -> A.Expr:
        while True:
            if self.at_op("["):
                loc = self.next().loc
                i = self.parse_expr()
                if self.at_op(","):
                    self.next()
                    n = self.parse_expr()
                    self.expect("op", "]")
                    e = A.ESlice(loc, e, i, n)
                else:
                    self.expect("op", "]")
                    e = A.EIdx(loc, e, i)
            elif self.at_op(".") and self.peek(1).kind in ("id", "kw"):
                loc = self.next().loc
                f = self.next().text
                e = A.EField(loc, e, f)
            else:
                return e

    def _call_args(self) -> Tuple[A.Expr, ...]:
        self.expect("op", "(")
        args: List[A.Expr] = []
        while not self.at_op(")"):
            if self.at("str"):
                t = self.next()
                args.append(A.EString(t.loc, t.text))
            else:
                args.append(self.parse_expr())
            if self.at_op(","):
                self.next()
        self.expect("op", ")")
        return tuple(args)

    def _atom(self) -> A.Expr:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return A.EInt(t.loc, int(t.text, 0))
        if t.kind == "float":
            self.next()
            return A.EFloat(t.loc, float(t.text))
        if t.kind == "bit":
            self.next()
            return A.EBit(t.loc, int(t.text))
        if t.kind == "str":
            self.next()
            return A.EString(t.loc, t.text)
        if self.at_kw("true"):
            self.next()
            return A.EBool(t.loc, True)
        if self.at_kw("false"):
            self.next()
            return A.EBool(t.loc, False)
        # casts / constructor calls on type keywords: int16(e), complex(a,b)
        if t.kind == "kw" and t.text in _BASE_TYPES and self.at_op("(", k=1):
            self.next()
            return A.ECall(t.loc, t.text, self._call_args())
        if t.kind == "id":
            self.next()
            if self.at_op("("):
                return A.ECall(t.loc, t.text, self._call_args())
            # struct literal: Name { f = e, ... } — only when the brace is
            # followed by `field =` (plain `=`; `==` lexes as one token),
            # so comp forms like `times n { x <- ... }` aren't swallowed
            if (self.at_op("{") and self.at("id", k=1)
                    and self.at_op("=", k=2)):
                self.next()
                fields: List[Tuple[str, A.Expr]] = []
                while not self.at_op("}"):
                    fn = self.expect("id").text
                    self.expect("op", "=")
                    fields.append((fn, self.parse_expr()))
                    if self.at_op(",") or self.at_op(";"):
                        self.next()
                self.expect("op", "}")
                return A.EStructLit(t.loc, t.text, tuple(fields))
            return A.EVar(t.loc, t.text)
        if self.at_op("{"):
            self.next()
            elems: List[A.Expr] = []
            while not self.at_op("}"):
                elems.append(self.parse_expr())
                if self.at_op(","):
                    self.next()
            self.expect("op", "}")
            return A.EArrLit(t.loc, tuple(elems))
        if self.at_op("("):
            self.next()
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        raise self.err(f"expected an expression, got {t.text or t.kind!r}")

    # ------------------------------------------------------------- stmts

    def parse_stmt_block(self) -> Tuple[A.Stmt, ...]:
        """'{' stmts '}' or a single statement."""
        if self.at_op("{"):
            self.next()
            out: List[A.Stmt] = []
            self._skip_semis()
            while not self.at_op("}"):
                out.append(self.parse_stmt())
                self._skip_semis()
            self.expect("op", "}")
            return tuple(out)
        return (self.parse_stmt(),)

    def parse_stmt(self) -> A.Stmt:
        t = self.peek()
        if self.at_kw("var"):
            self.next()
            name = self.expect("id").text
            self.expect("op", ":")
            ty = self.parse_type()
            init = None
            if self.at_op(":="):
                self.next()
                init = self.parse_expr()
            return A.SVar(t.loc, name, ty, init)
        if self.at_kw("let"):
            self.next()
            name = self.expect("id").text
            ty = None
            if self.at_op(":"):
                self.next()
                ty = self.parse_type()
            self.expect("op", "=")
            return A.SLet(t.loc, name, ty, self.parse_expr())
        if self.at_kw("if"):
            self.next()
            c = self.parse_expr()
            self.expect("kw", "then")
            then = self.parse_stmt_block()
            els: Tuple[A.Stmt, ...] = ()
            if self.at_kw("else"):
                self.next()
                els = self.parse_stmt_block()
            return A.SIf(t.loc, c, then, els)
        if self.at_kw("for"):
            self.next()
            var = self.expect("id").text
            self.expect("kw", "in")
            self.expect("op", "[")
            start = self.parse_expr()
            self.expect("op", ",")
            count = self.parse_expr()
            self.expect("op", "]")
            return A.SFor(t.loc, var, start, count, self.parse_stmt_block())
        if self.at_kw("while"):
            self.next()
            self.expect("op", "(")
            c = self.parse_expr()
            self.expect("op", ")")
            return A.SWhile(t.loc, c, self.parse_stmt_block())
        if self.at_kw("return"):
            self.next()
            return A.SReturn(t.loc, self.parse_expr())
        if self.at_kw("print", "println", "error"):
            kw = self.next().text
            args = self._call_args() if self.at_op("(") else self._bare_args()
            return A.SExpr(t.loc, A.ECall(t.loc, kw, args))
        # assignment or expression statement: parse a full expression
        # unconditionally — ':=' is not a binary operator, so parse_expr
        # stops right before it, and non-assignment statements like
        # `f(x) + g(y);` parse instead of erroring at the operator
        e = self.parse_expr()
        if self.at_op(":="):
            self.next()
            if not isinstance(e, (A.EVar, A.EIdx, A.ESlice, A.EField)):
                raise self.err("left side of := must be a variable, "
                               "element, slice, or field")
            return A.SAssign(t.loc, e, self.parse_expr())
        return A.SExpr(t.loc, e)

    def _bare_args(self) -> Tuple[A.Expr, ...]:
        """print "x", e, ... — unparenthesized argument list."""
        args: List[A.Expr] = []
        while True:
            if self.at("str"):
                tt = self.next()
                args.append(A.EString(tt.loc, tt.text))
            else:
                args.append(self.parse_expr())
            if self.at_op(","):
                self.next()
                continue
            return tuple(args)

    # ------------------------------------------------------------- comps

    def parse_comp(self) -> A.Comp:
        """C := S ( >>> S | |>>>| S )*  — left-assoc pipe chain."""
        c = self.parse_comp_seg()
        while self.at_op(">>>", "|>>>|"):
            t = self.next()
            rhs = self.parse_comp_seg()
            c = A.CPipe(t.loc, c, rhs, par=(t.text == "|>>>|"))
        return c

    def parse_comp_seg(self) -> A.Comp:
        if self.at_kw("seq") and self.at_op("{", k=1):
            self.next()
        if self.at_op("{"):
            return self._comp_block()
        return self._comp_atom()

    def _comp_block(self) -> A.Comp:
        """'{' item* '}' — right-nested bind/decl chain."""
        open_tok = self.expect("op", "{")
        items: List = []   # ('bind', loc, var, ty, comp) | ('var',...) etc.
        self._skip_semis()
        while not self.at_op("}"):
            t = self.peek()
            if self.at_kw("var"):
                self.next()
                name = self.expect("id").text
                self.expect("op", ":")
                ty = self.parse_type()
                init = None
                if self.at_op(":="):
                    self.next()
                    init = self.parse_expr()
                items.append(("var", t.loc, name, ty, init))
            elif self.at_kw("let") and self.at_kw("comp", k=1):
                self.next()
                self.next()
                name = self.expect("id").text
                self.expect("op", "=")
                items.append(("letcomp", t.loc, name, self.parse_comp()))
            elif self.at_kw("let"):
                self.next()
                name = self.expect("id").text
                self.expect("op", "=")
                items.append(("let", t.loc, name, self.parse_expr()))
            else:
                var, var_ty = self._try_bind_head()
                c = self.parse_comp()
                items.append(("bind", t.loc, var, var_ty, c))
            self._skip_semis()
        self.expect("op", "}")
        if not items:
            raise ParseError(
                f"{self.src_name}:{open_tok.line}:{open_tok.col}: "
                f"empty computation block")

        # fold right: last item is the block's value position
        last = items[-1]
        if last[0] != "bind":
            raise self.err("a computation block must end with a "
                           "computation, not a declaration")
        if last[2] is not None:
            raise ParseError(
                f"{self.src_name}:{last[1][0]}:{last[1][1]}: the final "
                f"computation in a block cannot be a bind (its value "
                f"would be unused)")
        comp: A.Comp = last[4]
        for it in reversed(items[:-1]):
            if it[0] == "bind":
                comp = A.CBind(it[1], it[2], it[3], it[4], comp)
            elif it[0] == "var":
                comp = A.CVarDecl(it[1], it[2], it[3], it[4], comp)
            elif it[0] == "let":
                comp = A.CLetDecl(it[1], it[2], it[3], comp)
            elif it[0] == "letcomp":
                comp = A.CLetComp(it[1], it[2], it[3], comp)
        return comp

    def _try_bind_head(self):
        """Recognize `NAME <-` or `(NAME : ty) <-`; returns (var, ty)."""
        if self.at("id") and self.at_op("<-", k=1):
            var = self.next().text
            self.next()
            return var, None
        if (self.at_op("(") and self.peek(1).kind == "id"
                and self.at_op(":", k=2)):
            save = self.pos
            self.next()
            var = self.next().text
            self.next()
            try:
                ty = self.parse_type()
            except ParseError:
                self.pos = save
                return None, None
            if self.at_op(")") and self.at_op("<-", k=1):
                self.next()
                self.next()
                return var, ty
            self.pos = save
        return None, None

    def _comp_atom(self) -> A.Comp:
        t = self.peek()
        if self.at_kw("take"):
            self.next()
            return A.CTake(t.loc)
        if self.at_kw("takes"):
            self.next()
            return A.CTakes(t.loc, self.parse_expr())
        if self.at_kw("emit"):
            self.next()
            return A.CEmit(t.loc, self.parse_expr())
        if self.at_kw("emits"):
            self.next()
            return A.CEmits(t.loc, self.parse_expr())
        if self.at_kw("return"):
            self.next()
            return A.CReturn(t.loc, self.parse_expr())
        if self.at_kw("do"):
            self.next()
            if self.at_op("{"):
                body = self.parse_stmt_block()
                if self.at_kw("until"):   # do S until (E)
                    return self._finish_until(t, A.CDo(t.loc, body))
                return A.CDo(t.loc, body)
            seg = self.parse_comp_seg()
            return self._finish_until(t, seg)
        if self.at_kw("repeat"):
            self.next()
            return A.CRepeat(t.loc, self.parse_comp_seg())
        if self.at_kw("map"):
            self.next()
            return A.CMap(t.loc, self.expect("id").text)
        if self.at_kw("if"):
            self.next()
            c = self.parse_expr()
            self.expect("kw", "then")
            then = self.parse_comp_arm()
            els = None
            if self.at_kw("else"):
                self.next()
                els = self.parse_comp_arm()
            return A.CIf(t.loc, c, then, els)
        if self.at_kw("for"):
            self.next()
            var = self.expect("id").text
            self.expect("kw", "in")
            self.expect("op", "[")
            start = self.parse_expr()
            self.expect("op", ",")
            count = self.parse_expr()
            self.expect("op", "]")
            return A.CFor(t.loc, var, start, count, self.parse_comp_seg())
        if self.at_kw("times"):
            self.next()
            count = self.parse_expr()
            return A.CTimes(t.loc, count, self.parse_comp_seg())
        if self.at_kw("while"):
            self.next()
            self.expect("op", "(")
            c = self.parse_expr()
            self.expect("op", ")")
            return A.CWhile(t.loc, c, self.parse_comp_seg())
        if self.at_kw("until"):
            # prefix form: until (E) S — body runs, then the condition is
            # checked (at-least-once loop, the reference's `until`)
            self.next()
            self.expect("op", "(")
            c = self.parse_expr()
            self.expect("op", ")")
            return A.CUntil(t.loc, c, self.parse_comp_seg())
        if self.at_kw("read"):
            self.next()
            ty = None
            if self.at_op("["):
                self.next()
                ty = self.parse_type()
                self.expect("op", "]")
            return A.CRead(t.loc, ty)
        if self.at_kw("write"):
            self.next()
            ty = None
            if self.at_op("["):
                self.next()
                ty = self.parse_type()
                self.expect("op", "]")
            return A.CWrite(t.loc, ty)
        if t.kind == "id":
            self.next()
            if self.at_op("("):
                return A.CCall(t.loc, t.text, self._call_args())
            return A.CCall(t.loc, t.text, ())
        if self.at_op("("):
            self.next()
            c = self.parse_comp()
            self.expect("op", ")")
            return c
        raise self.err(
            f"expected a computation, got {t.text or t.kind!r}")

    def parse_comp_arm(self) -> A.Comp:
        """An if-arm: a segment, possibly itself a pipe in parens."""
        return self.parse_comp_seg()

    def _finish_until(self, t: Token, body: A.Comp) -> A.Comp:
        self.expect("kw", "until")
        self.expect("op", "(")
        c = self.parse_expr()
        self.expect("op", ")")
        return A.CUntil(t.loc, c, body)

    # ------------------------------------------------------------- decls

    def _params(self) -> Tuple[A.Param, ...]:
        self.expect("op", "(")
        ps: List[A.Param] = []
        while not self.at_op(")"):
            t = self.expect("id")
            ty = None
            if self.at_op(":"):
                self.next()
                ty = self.parse_type()
            ps.append(A.Param(t.text, ty, t.loc))
            if self.at_op(","):
                self.next()
        self.expect("op", ")")
        return tuple(ps)

    def parse_program(self) -> A.Program:
        decls: List[A.Decl] = []
        self._skip_semis()
        while not self.at("eof"):
            decls.append(self.parse_decl())
            self._skip_semis()
        return A.Program(tuple(decls))

    def parse_decl(self) -> A.Decl:
        t = self.peek()
        if self.at_kw("fun") and self.at_kw("comp", k=1):
            self.next()
            self.next()
            name = self.expect("id").text
            params = self._params()
            body = self.parse_comp_seg()
            return A.DFunComp(t.loc, name, params, body)
        if self.at_kw("fun"):
            self.next()
            name = self.expect("id").text
            params = self._params()
            ret = None
            if self.at_op(":"):
                self.next()
                ret = self.parse_type()
            body = self.parse_stmt_block()
            return A.DFun(t.loc, name, params, ret, body)
        if self.at_kw("ext"):
            self.next()
            self.expect("kw", "fun")
            name = self.expect("id").text
            params = self._params()
            ret = None
            if self.at_op(":"):
                self.next()
                ret = self.parse_type()
            return A.DExt(t.loc, name, params, ret)
        if self.at_kw("let") and self.at_kw("comp", k=1):
            self.next()
            self.next()
            name = self.expect("id").text
            self.expect("op", "=")
            return A.DLetComp(t.loc, name, self.parse_comp())
        if self.at_kw("let"):
            self.next()
            name = self.expect("id").text
            self.expect("op", "=")
            return A.DLet(t.loc, name, self.parse_expr())
        if self.at_kw("struct"):
            self.next()
            name = self.expect("id").text
            if self.at_op("="):
                self.next()
            self.expect("op", "{")
            fields: List[Tuple[str, A.Ty]] = []
            while not self.at_op("}"):
                fn = self.expect("id").text
                self.expect("op", ":")
                fields.append((fn, self.parse_type()))
                if self.at_op(";") or self.at_op(","):
                    self.next()
            self.expect("op", "}")
            return A.DStruct(t.loc, name, tuple(fields))
        raise self.err(
            f"expected a declaration (fun/let/ext/struct), got "
            f"{t.text or t.kind!r}")


def parse_program(src: str, src_name: str = "<input>") -> A.Program:
    return Parser(src, src_name).parse_program()


def parse_comp(src: str, src_name: str = "<input>") -> A.Comp:
    p = Parser(src, src_name)
    c = p.parse_comp()
    p.expect("eof")
    return c


def parse_expr(src: str, src_name: str = "<input>") -> A.Expr:
    p = Parser(src, src_name)
    e = p.parse_expr()
    p.expect("eof")
    return e
