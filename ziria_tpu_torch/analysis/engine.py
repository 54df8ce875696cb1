"""Lint engine: pure-``ast`` static analysis over the port's tree
(counterpart of ziria_tpu/analysis/engine.py).

The machinery under ``python -m ziria_tpu_torch.analysis`` (and the
CLI's ``lint`` subcommand): walk Python sources, hand each registered
rule a parsed module with parent links, collect :class:`Finding`\\ s,
apply ``# ziria: lint-ignore[<rule>] reason`` suppression pragmas, and
render text or JSON. It imports neither torch nor numpy: an
ahead-of-time analysis runs before, and without, the runtime it
polices.

Rules live in :mod:`ziria_tpu_torch.analysis.rules`; adding one is:
write a ``Rule`` subclass with a unique ``id`` and a ``check(ctx)`` that
calls ``ctx.report(node, message)``, and append it to
``rules.ALL_RULES``.

Pragma grammar (suppressions the gate treats as reviewed, so every
one must carry a justification — a bare pragma is itself a finding,
and so is a pragma that no longer suppresses anything; only real
COMMENT tokens register, so a docstring or string literal quoting the
syntax — like this one — can never suppress anything):

    # ziria: lint-ignore[R2] why this finding is safe      (this line
                                                            or the next)
    # ziria: lint-ignore-file[R4] why for the whole file
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(
    r"#\s*ziria:\s*lint-ignore(?P<file>-file)?"
    r"\[(?P<rules>[A-Za-z0-9_,\s]+)\]\s*(?P<reason>.*\S)?")

#: rule id reserved for engine-level findings (unparseable file,
#: reasonless pragma) — not suppressible by design
META_RULE = "lint"


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    file: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: " \
               f"{self.rule} {self.message}"


@dataclass
class Pragma:
    line: int
    rules: Tuple[str, ...]
    reason: str
    file_level: bool
    used: bool = False


class Module:
    """One parsed source file with the lookups rules need: parent
    links (``parent_of``), the raw lines, and the module-level
    assignment/`global` tables the cache-key rule reads."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parent: Dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self._parent[id(child)] = node

    def parent_of(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parent.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent_of(node)
        while cur is not None:
            yield cur
            cur = self.parent_of(cur)

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing function definitions
        (empty == module level, i.e. import time)."""
        return [a for a in self.ancestors(node)
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]


class Context:
    """Per-file rule context: ``report`` accumulates findings for the
    rule currently running."""

    def __init__(self, module: Module):
        self.module = module
        self.findings: List[Finding] = []
        self._rule_id = META_RULE

    def report(self, node: ast.AST, message: str,
               rule_id: Optional[str] = None) -> None:
        self.findings.append(Finding(
            self.module.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0) + 1,
            rule_id or self._rule_id, message))


class Rule:
    """Base class: subclass with a class-level ``id``/``name``/``why``
    and implement :meth:`check`."""

    id = "R0"
    name = "unnamed"
    #: one-line motivation shown by --list-rules
    why = ""

    def check(self, ctx: Context) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


# ----------------------------------------------------------- AST helpers
#
# Shared by the rules; kept here so a new rule composes them instead of
# re-deriving dotted-name plumbing.


def qual_name(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain
    chain): ``torch.cuda.synchronize`` -> "torch.cuda.synchronize",
    ``self._fns`` -> "self._fns"."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def last_component(name: str) -> str:
    """Final dotted component, leading underscores stripped — the
    form the naming-convention patterns match against."""
    return name.rsplit(".", 1)[-1].lstrip("_")


def decorator_names(fn: ast.AST) -> List[str]:
    out = []
    for d in getattr(fn, "decorator_list", []):
        if isinstance(d, ast.Call):
            d = d.func
        q = qual_name(d)
        if q:
            out.append(q)
    return out


def is_lru_cached(fn: ast.AST) -> bool:
    return any(q.rsplit(".", 1)[-1] in ("lru_cache", "cache")
               for q in decorator_names(fn))


def in_timed_block(module: Module, node: ast.AST) -> bool:
    """True when ``node`` sits inside a ``with dispatch.timed(...)``
    (or bare ``timed(...)``) block body."""
    for anc in module.ancestors(node):
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call) and \
                    last_component(qual_name(expr.func)) == "timed":
                return True
    return False


def is_env_read(node: ast.AST) -> bool:
    """An ``os.environ`` access or ``os.getenv`` call (any alias whose
    chain ends in .environ / .getenv, or a bare imported ``environ`` /
    ``getenv``)."""
    if isinstance(node, ast.Call):
        return qual_name(node.func).rsplit(".", 1)[-1] == "getenv"
    q = qual_name(node)
    return bool(q) and q.rsplit(".", 1)[-1] == "environ"


ENV_WRITE_METHODS = ("update", "pop", "setdefault", "clear")


def env_write_target(node: ast.AST) -> Optional[ast.AST]:
    """The offending node when ``node`` mutates the process
    environment: ``os.environ[k] = v`` / ``del os.environ[k]`` (an
    Assign/Delete whose target subscripts environ), or a call to
    ``os.environ.update/pop/setdefault/clear`` / ``os.putenv``."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and is_env_read(t.value):
                return t
    if isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and is_env_read(t.value):
                return t
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in ENV_WRITE_METHODS and is_env_read(f.value):
                return node
            if f.attr == "putenv":
                return node
    return None


# ------------------------------------------------------------ file driver


def collect_pragmas(source: str) -> List[Pragma]:
    """Pragmas from the file's real COMMENT tokens only — a docstring
    or string literal that merely *quotes* the pragma syntax must
    never register as a live suppression (engine.py's own module
    docstring is the proof case)."""
    out = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in toks
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return []          # unparseable: lint_source reports it first
    for i, text in comments:
        m = PRAGMA_RE.search(text)
        if m:
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            out.append(Pragma(i, rules, (m.group("reason") or "").strip(),
                              bool(m.group("file"))))
    return out


@dataclass
class FileResult:
    path: str
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Sequence[Rule]] = None) -> FileResult:
    """Lint one source string. Parse failures are reported as a
    ``lint`` finding, never an exception — a broken file must fail
    the gate, not crash it."""
    from ziria_tpu_torch.analysis.rules import ALL_RULES

    res = FileResult(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        res.findings.append(Finding(
            path, e.lineno or 0, (e.offset or 0), META_RULE,
            f"syntax error: {e.msg}"))
        return res
    module = Module(path, source, tree)
    ctx = Context(module)
    for rule in (rules if rules is not None else ALL_RULES):
        ctx._rule_id = rule.id
        rule.check(ctx)
    # rules that walk per-function see nested defs twice (once from
    # the outer walk): identical findings collapse to one
    ctx.findings = list(dict.fromkeys(ctx.findings))

    pragmas = collect_pragmas(source)
    file_pragmas: Dict[str, List[Pragma]] = {}
    line_rules: Dict[int, List[Pragma]] = {}
    for p in pragmas:
        if p.file_level:
            for r in p.rules:
                file_pragmas.setdefault(r, []).append(p)
        else:
            line_rules.setdefault(p.line, []).append(p)

    kept: List[Finding] = []
    for f in ctx.findings:
        if f.rule != META_RULE and f.rule in file_pragmas:
            for p in file_pragmas[f.rule]:
                p.used = True
            res.suppressed += 1
            continue
        hit = None
        for p in line_rules.get(f.line, []) + \
                line_rules.get(f.line - 1, []):
            if f.rule != META_RULE and f.rule in p.rules:
                hit = p
                break
        if hit is not None:
            hit.used = True
            res.suppressed += 1
            continue
        kept.append(f)
    # the gate's contract is that every pragma is a reviewed trade:
    # one without a justification is itself a finding, and so is one
    # that no longer suppresses anything (the fixed-finding creep a
    # stale pragma would otherwise silently mask forever). Unused is
    # only decidable for rules that actually RAN — under a --rules
    # subset, pragmas for unrun rules are left alone.
    ran = {r.id for r in (rules if rules is not None else ALL_RULES)}
    for p in pragmas:
        if not p.reason:
            kept.append(Finding(
                path, p.line, 1, META_RULE,
                "lint-ignore pragma without a justification "
                "(write WHY the finding is safe to suppress)"))
        elif not p.used and set(p.rules) <= ran:
            kept.append(Finding(
                path, p.line, 1, META_RULE,
                f"unused lint-ignore pragma "
                f"[{','.join(p.rules)}]: it suppresses no finding — "
                f"the issue was fixed, so remove the pragma"))
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    res.findings = kept
    return res


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__",)
                                 and not d.startswith("."))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            out.append(p)
    return out


@dataclass
class LintResult:
    findings: List[Finding]
    files: int
    suppressed: int

    @property
    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for f in self.findings:
            c[f.rule] = c.get(f.rule, 0) + 1
        return c

    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "files": self.files,
            "suppressed": self.suppressed,
            "counts": self.counts,
            "findings": [{
                "file": f.file, "line": f.line, "col": f.col,
                "rule": f.rule, "message": f.message,
            } for f in self.findings],
        }, indent=2, sort_keys=True)


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[Rule]] = None) -> LintResult:
    """Lint every ``.py`` under ``paths`` (files or directories): the
    library entry the CLI and the test gate
    (tests/test_torch_lint.py) share."""
    findings: List[Finding] = []
    suppressed = 0
    files = iter_py_files(paths)
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            findings.append(Finding(path, 0, 0, META_RULE,
                                    f"unreadable: {e}"))
            continue
        res = lint_source(src, path, rules=rules)
        findings.extend(res.findings)
        suppressed += res.suppressed
    return LintResult(findings, len(files), suppressed)
