"""REPRO-K*: the port's CUDA launch path, checked before any launch.

The port reaches its kernels through ctypes: ``kernels/_build.py`` types
each ``extern "C"`` entry point of ``kernels/csrc/*.cu`` by hand
(``_SIGNATURES``), the wrappers ``kernels/rst_*.py`` call them with
positional arguments, and ``kernels/ops.py`` packs the int32 operands the
wrappers unpack into launch arguments.  A host without a card can run
none of that path, and ctypes checks none of it: an argument too few, or
a ``c_int`` where C takes ``int64_t``, corrupts memory silently, and only
the card shows it.  Every invariant below is decidable from the sources:

* **REPRO-K001** — entry-point signatures: every ``extern "C"`` function
  of ``csrc/*.cu`` has exactly one ctypes typing in ``_build.py`` (a
  ``_SIGNATURES`` row or an explicit ``.argtypes``), with its argument
  count, each argument's type (``int`` <-> ``c_int``, ``int64_t`` <->
  ``c_int64``, any pointer <-> ``c_void_p``) and its return type; every
  typing names a C function; and every call ``library().<name>(...)`` /
  ``lib.<name>(...)`` in ``kernels/*.py`` passes exactly that many
  positional arguments (ctypes accepts surplus ones without complaint).
* **REPRO-K002** — int32 guard: every operand packer (an ``ops.py``
  function named ``*operand``) calls the host-side int32 range guard
  ``_require_int32_index_range``, directly or through a same-module
  helper, and a packer that takes an
  engine count hands it to the guard: N disjoint windows span
  ``base + N * wset`` blocks, wider than one engine's range.
* **REPRO-K003** — documented operand shapes: each packer builds the
  length (or table row width) that the wrappers name and check its
  operand against (``OPERAND_LEN``, ``CONTENDED_OPERAND_LEN``,
  ``MIX_ROW``), some comparison in the wrappers reads that name, and the
  shapes the docstrings state (``int32[4]``, ``int32[6]``,
  ``int32[N+1, 4]``) equal what the packer builds: the packer's own and
  those of the wrapper functions that read the name or call one that
  does.
* **REPRO-K004** — working buffers: each buffer maker sizes the buffer
  from the RST base ``p.a`` as well as the windows (the kernels address
  from ``base_block = A // tile`` upward).
* **REPRO-K005** — dtype codes: ``DTYPE_CODES`` of the read wrapper
  equals the ``kFloat32``/``kBFloat16``/``kInt8`` constants the C
  sources switch on.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.astutil import (call_name, int_const,
                                          module_functions, parse_module)
from repro_torch.analysis.findings import Finding

SIGNATURE_TABLE = "_SIGNATURES"
DTYPE_TABLE = "DTYPE_CODES"
BUFFER_MAKERS = ("make_working_buffer", "make_mix_working_buffer")
GUARD = "_require_int32_index_range"
# Operand packer -> the module-level constant of a kernel wrapper that
# names the length (a table: the row width) the wrappers check it against.
OPERAND_LENGTHS = {
    "params_operand": "OPERAND_LEN",
    "contended_params_operand": "CONTENDED_OPERAND_LEN",
    "mix_params_operand": "MIX_ROW",
}
_ENGINE_PARAM = "num_engines"
# The guard's positional parameters: stride, wset, base, n, num_engines.
_GUARD_ENGINE_POSITION = 4

# ctypes types a C type of the entry points may be bound to; a C type
# not listed here matches no ctypes type.
_POINTER, _CHAR_POINTER = "pointer", "char pointer"
ACCEPTED_CTYPES: Dict[str, Tuple[str, ...]] = {
    "int": ("c_int", "c_int32"),
    "int64_t": ("c_int64", "c_longlong"),
    _POINTER: ("c_void_p",),
    _CHAR_POINTER: ("c_char_p", "c_void_p"),
}
_C_QUALIFIERS = frozenset({"const", "volatile", "static", "inline"})
# torch dtype attribute -> suffix of its constant in the C sources, where
# it is not the attribute capitalized (float32 -> kFloat32).
_DTYPE_C_NAMES = {"bfloat16": "BFloat16"}

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_HEADER = re.compile(r"^(?P<ret>[\w\s\*&:]*?)\b(?P<name>[A-Za-z_]\w*)\s*"
                     r"\((?P<params>[^()]*)\)\s*$", re.S)
_C_CONSTANT = re.compile(r"constexpr\s+int\s+(k\w+)\s*=\s*(-?\d+)\s*;")
_DOC_SHAPE = re.compile(r"int32\[([^\]]+)\]")


def _rel(path: Path, root: Optional[Path]) -> str:
    if root is not None:
        try:
            return str(path.relative_to(root))
        except ValueError:
            pass
    return str(path)


# ------------------------------------------------------------ C sources
@dataclasses.dataclass(frozen=True)
class CFunction:
    """One ``extern "C"`` function: its normalised return type and
    ``(type, name)`` per parameter."""

    name: str
    returns: str
    params: Tuple[Tuple[str, str], ...]
    path: Path
    line: int


def _strip_comments(text: str) -> str:
    """Comments and preprocessor lines blanked out, newlines kept (line
    numbers stay right)."""
    text = _COMMENT.sub(lambda m: "\n" * m.group(0).count("\n"), text)
    return re.sub(r"(?m)^[ \t]*#.*$", "", text)


def _c_type(decl: str) -> Tuple[str, str]:
    """(normalised type, name) of one declaration: ``const void* buf`` ->
    ("pointer", "buf"), ``int64_t n`` -> ("int64_t", "n")."""
    words = [w for w in re.findall(r"[A-Za-z_]\w*", decl)
             if w not in _C_QUALIFIERS]
    name = words.pop() if len(words) >= 2 else ""
    if "*" in decl or "[" in decl:
        return (_CHAR_POINTER if words == ["char"] else _POINTER), name
    return " ".join(words), name


def _matching_brace(text: str, pos: int) -> int:
    """Index just past the brace that closes the one at `pos`."""
    depth = 0
    for i in range(pos, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def _declarations(text: str, start: int, end: int, path: Path,
                  first_only: bool = False) -> List[CFunction]:
    """Function declarations and definitions at brace depth 0 of
    text[start:end]; bodies are skipped."""
    out: List[CFunction] = []
    head_start, i = start, start
    while i < end:
        ch = text[i]
        if ch not in "{;}":
            i += 1
            continue
        header = text[head_start:i]
        match = _HEADER.match(header.strip())
        if ch != "}" and match is not None:
            params = match.group("params").strip()
            decls = [] if params in ("", "void") else params.split(",")
            offset = head_start + header.index(match.group("name"))
            out.append(CFunction(
                name=match.group("name"),
                returns=_c_type(match.group("ret") + " _")[0],
                params=tuple(_c_type(d) for d in decls), path=path,
                line=text.count("\n", 0, offset) + 1))
        i = _matching_brace(text, i) if ch == "{" else i + 1
        head_start = i
        if first_only and ch != "}":
            break
    return out


def extern_c_functions(paths: Iterable[Path]) -> List[CFunction]:
    """Every function declared or defined inside ``extern "C"`` in the
    given C/CUDA sources, first occurrence of each name."""
    seen: Dict[str, CFunction] = {}
    for path in paths:
        text = _strip_comments(path.read_text())
        for match in re.finditer(r'extern\s+"C"\s*', text):
            pos = match.end()
            if text.startswith("{", pos):
                fns = _declarations(text, pos + 1,
                                    _matching_brace(text, pos) - 1, path)
            else:
                fns = _declarations(text, pos, len(text), path,
                                    first_only=True)
            for fn in fns:
                seen.setdefault(fn.name, fn)
    return list(seen.values())


# ---------------------------------------------------- ctypes signatures
@dataclasses.dataclass(frozen=True)
class CtypesSignature:
    """The ctypes typing of one entry point: argument types by ctypes
    name (``"?"`` where not resolvable), the return type (None: ctypes'
    default ``c_int``), and whether the argument types were set."""

    name: str
    argtypes: Optional[Tuple[str, ...]]
    restype: Optional[str]
    line: int


def _ctypes_aliases(tree: ast.Module) -> Dict[str, str]:
    """Module-level names bound to ctypes types (``_c_int = ctypes.c_int``,
    also in tuple assignments)."""
    aliases: Dict[str, str] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            pairs: List[Tuple[ast.expr, ast.expr]] = [(target, node.value)]
            if isinstance(target, ast.Tuple) \
                    and isinstance(node.value, ast.Tuple) \
                    and len(target.elts) == len(node.value.elts):
                pairs = list(zip(target.elts, node.value.elts))
            for name, value in pairs:
                if isinstance(name, ast.Name):
                    resolved = _ctype_name(value, aliases)
                    if resolved != "?":
                        aliases[name.id] = resolved
    return aliases


def _ctype_name(node: ast.AST, aliases: Dict[str, str]) -> str:
    if isinstance(node, ast.Attribute) and node.attr.startswith("c_"):
        return node.attr
    if isinstance(node, ast.Name):
        if node.id in aliases:
            return aliases[node.id]
        if node.id.startswith("c_"):
            return node.id
    return "?"


def _ctype_list(node: ast.AST, aliases: Dict[str, str]
                ) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Call) and call_name(node) in ("list", "tuple") \
            and node.args:
        node = node.args[0]
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_ctype_name(e, aliases) for e in node.elts)
    return None


def ctypes_signatures(build_path: Path) -> Tuple[Optional[Dict[str, CtypesSignature]],
                                 Dict[str, CtypesSignature]]:
    """(rows of the signature table, None if the module has none; the
    entry points typed one by one, ``lib.<name>.argtypes = [...]``)."""
    tree = parse_module(build_path)
    aliases = _ctypes_aliases(tree)
    table_restype: Optional[str] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Call) \
                and isinstance(node.iter.func, ast.Attribute) \
                and isinstance(node.iter.func.value, ast.Name) \
                and node.iter.func.value.id == SIGNATURE_TABLE:
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.targets[0], ast.Attribute) \
                        and stmt.targets[0].attr == "restype":
                    table_restype = _ctype_name(stmt.value, aliases)
    rows: Optional[Dict[str, CtypesSignature]] = None
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Dict):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if not any(isinstance(t, ast.Name) and t.id == SIGNATURE_TABLE
                       for t in targets):
                continue
            rows = {}
            for key, value in zip(node.value.keys, node.value.values):
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str):
                    rows[key.value] = CtypesSignature(
                        key.value, _ctype_list(value, aliases),
                        table_restype, key.lineno)
    explicit: Dict[str, CtypesSignature] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if not (isinstance(target, ast.Attribute)
                and target.attr in ("argtypes", "restype")
                and isinstance(target.value, ast.Attribute)):
            continue
        name = target.value.attr
        prior = explicit.get(name, CtypesSignature(name, None, None,
                                                   node.lineno))
        if target.attr == "argtypes":
            prior = dataclasses.replace(
                prior, argtypes=_ctype_list(node.value, aliases) or ("?",))
        else:
            prior = dataclasses.replace(
                prior, restype=_ctype_name(node.value, aliases))
        explicit[name] = prior
    return rows, explicit


def _library_receivers(tree: ast.Module) -> Set[str]:
    """Names bound to the loaded library (``lib = _build.library()``)."""
    return {target.id for node in ast.walk(tree)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and call_name(node.value) == "library"
            for target in node.targets if isinstance(target, ast.Name)}


def _library_calls(tree: ast.Module) -> List[ast.Call]:
    receivers = _library_receivers(tree)
    calls = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        recv = node.func.value
        if (isinstance(recv, ast.Call) and call_name(recv) == "library") \
                or (isinstance(recv, ast.Name) and recv.id in receivers):
            calls.append(node)
    return calls


def _describe(types: Sequence[str]) -> str:
    return "(" + ", ".join(types) + ")"


def _typing_findings(sig: CtypesSignature, fn: CFunction, build_rel: str,
                     c_file: str) -> List[Finding]:
    """One ctypes typing of `fn` against its C declaration (named by file
    only: messages are the baseline's identity)."""
    name, c_types = fn.name, [t for t, _ in fn.params]
    findings: List[Finding] = []

    def add(message: str, hint: str) -> None:
        findings.append(Finding(invariant="REPRO-K001", path=build_rel,
                                line=sig.line, message=message, hint=hint))

    if sig.argtypes is None:
        add(f"{name}() has a restype but no argtypes; C takes "
            f"{_describe(c_types)} ({c_file})",
            f"set {name}.argtypes to match its C declaration")
    elif len(sig.argtypes) != len(c_types):
        add(f"{name}() is typed with {len(sig.argtypes)} arguments but "
            f"its extern \"C\" declaration ({c_file}) takes {len(c_types)}",
            f"type every argument of {name}() in order: "
            f"{_describe(c_types)}")
    else:
        for i, (py, (c_type, c_name)) in enumerate(
                zip(sig.argtypes, fn.params)):
            accepted = ACCEPTED_CTYPES.get(c_type, ())
            if py not in accepted:
                add(f"{name}() argument {i} ({c_name}) is {c_type} in C "
                    f"({c_file}) but {py} in ctypes",
                    f"bind {c_type} as "
                    f"{' or '.join(accepted) or 'a matching type'}")
    restype = sig.restype or "c_int"
    accepted = ACCEPTED_CTYPES.get(fn.returns, ())
    if restype not in accepted:
        add(f"{name}() returns {fn.returns} in C ({c_file}) but its "
            f"ctypes restype is {restype}",
            f"set {name}.restype to "
            f"{' or '.join(accepted) or 'a matching type'}")
    return findings


def check_entry_points(build_path: Path, csrc_paths: Sequence[Path],
                       caller_paths: Sequence[Path], *,
                       repo_root: Optional[Path] = None) -> List[Finding]:
    """K001: the ctypes typings and call sites against the ``extern "C"``
    declarations."""
    build_rel = _rel(build_path, repo_root)
    c_fns = {f.name: f for f in extern_c_functions(csrc_paths)}
    rows, explicit = ctypes_signatures(build_path)
    findings: List[Finding] = []
    if rows is None:
        findings.append(Finding(
            invariant="REPRO-K001", path=build_rel, line=1,
            message=f"{SIGNATURE_TABLE} table not found",
            hint=(f"keep the ctypes signatures in a module-level "
                  f"{SIGNATURE_TABLE} dict the analyzer can read")))
        rows = {}

    for name, fn in sorted(c_fns.items()):
        typings = [t for t in (rows.get(name), explicit.get(name)) if t]
        if not typings:
            findings.append(Finding(
                invariant="REPRO-K001", path=_rel(fn.path, repo_root),
                line=fn.line,
                message=(f'extern "C" function {name}() has no ctypes '
                         f"signature in {build_rel}"),
                hint=(f"add a {SIGNATURE_TABLE} row typing every argument "
                      f"of {name}() (an untyped pointer is cut to 32 "
                      f"bits)")))
            continue
        for sig in typings:
            findings += _typing_findings(sig, fn, build_rel,
                                         _rel(fn.path, repo_root))
    for name, sig in sorted({**rows, **explicit}.items()):
        if name not in c_fns:
            findings.append(Finding(
                invariant="REPRO-K001", path=build_rel, line=sig.line,
                message=(f"ctypes signature {name}() names no extern \"C\" "
                         f"function of the kernel sources"),
                hint="drop the typing or restore the C entry point"))

    for path in caller_paths:
        caller_rel = _rel(path, repo_root)
        for call in _library_calls(parse_module(path)):
            name = call.func.attr  # type: ignore[attr-defined]
            fn = c_fns.get(name)
            if fn is None:
                findings.append(Finding(
                    invariant="REPRO-K001", path=caller_rel,
                    line=call.lineno,
                    message=(f"calls {name}() on the kernel library, which "
                             f"no extern \"C\" function defines"),
                    hint="call an entry point of csrc/*.cu"))
            elif call.keywords or any(isinstance(a, ast.Starred)
                                      for a in call.args):
                findings.append(Finding(
                    invariant="REPRO-K001", path=caller_rel,
                    line=call.lineno,
                    message=(f"calls {name}() with keyword or unpacked "
                             f"arguments, which ctypes cannot check"),
                    hint="pass every argument positionally"))
            elif len(call.args) != len(fn.params):
                findings.append(Finding(
                    invariant="REPRO-K001", path=caller_rel,
                    line=call.lineno,
                    message=(f"passes {len(call.args)} arguments to "
                             f"{name}(), which takes {len(fn.params)} "
                             f"({_rel(fn.path, repo_root)})"),
                    hint=(f"pass {name}() exactly its C arguments: "
                          f"{', '.join(n for _, n in fn.params)}")))
    return findings


# ------------------------------------------------------------- modules
class _Modules:
    """Parsed modules, and the functions a module defines or imports from
    another module of the tree (``from repro_torch.x.y import f``,
    resolved against the importer's ancestors, then its directory)."""

    def __init__(self) -> None:
        self._trees: Dict[Path, ast.Module] = {}

    def tree(self, path: Path) -> ast.Module:
        if path not in self._trees:
            self._trees[path] = parse_module(path)
        return self._trees[path]

    def _module_path(self, importer: Path, module: str) -> Optional[Path]:
        rel = Path(*module.split(".")).with_suffix(".py")
        for parent in importer.parents:
            if (parent / rel).exists():
                return parent / rel
        sibling = importer.parent / rel.name
        return sibling if sibling.exists() else None

    def resolve(self, path: Path, name: str
                ) -> Optional[Tuple[Path, ast.FunctionDef]]:
        tree = self.tree(path)
        fns = module_functions(tree)
        if name in fns:
            return path, fns[name]
        for node in tree.body:
            if not (isinstance(node, ast.ImportFrom) and node.module):
                continue
            for alias in node.names:
                if (alias.asname or alias.name) != name:
                    continue
                target = self._module_path(path, node.module)
                if target is not None and target != path:
                    found = module_functions(self.tree(target)).get(
                        alias.name)
                    if found is not None:
                        return target, found
        return None


def _called_names(fn: ast.FunctionDef) -> Set[str]:
    return {node.func.id for node in ast.walk(fn)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}


# ------------------------------------------------------- the int32 guard
def _guard_calls(fn: ast.FunctionDef, fns: Dict[str, ast.FunctionDef],
                 seen: Optional[Set[str]] = None) -> List[ast.Call]:
    """Calls to the int32-range guard in `fn` or the same-module helpers
    it calls (the mix packer guards each table row inside
    `_mix_block_rows`)."""
    seen = set() if seen is None else seen
    seen.add(fn.name)
    calls = [node for node in ast.walk(fn) if isinstance(node, ast.Call)
             and call_name(node) == GUARD]
    for callee in sorted(_called_names(fn)):
        if callee in fns and callee not in seen:
            calls += _guard_calls(fns[callee], fns, seen)
    return calls


def _guards_engines(call: ast.Call) -> bool:
    return (any(kw.arg == _ENGINE_PARAM for kw in call.keywords)
            or len(call.args) > _GUARD_ENGINE_POSITION)


def _param_names(fn: ast.FunctionDef) -> List[str]:
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


def _packers(fns: Dict[str, ast.FunctionDef]) -> List[ast.FunctionDef]:
    return [fn for name, fn in sorted(fns.items())
            if name.endswith("operand")]


def check_operand_guards(ops_path: Path, *,
                         repo_root: Optional[Path] = None) -> List[Finding]:
    """K002: every operand packer reaches the int32 guard, with the
    engine count where it packs one."""
    ops_rel = _rel(ops_path, repo_root)
    fns = module_functions(parse_module(ops_path))
    findings: List[Finding] = []
    for fn in _packers(fns):
        calls = _guard_calls(fn, fns)
        if not calls:
            findings.append(Finding(
                invariant="REPRO-K002", path=ops_rel, line=fn.lineno,
                message=(f"{fn.name}() packs operands whose index "
                         f"arithmetic can exceed int32 with no host-side "
                         f"range guard"),
                hint=("validate (n-1)*stride_blocks and "
                      "base+engines*wset_blocks against 2**31 before "
                      f"packing (call {GUARD} so the analyzer can see "
                      f"it)")))
        elif _ENGINE_PARAM in _param_names(fn) \
                and not any(_guards_engines(c) for c in calls):
            findings.append(Finding(
                invariant="REPRO-K002", path=ops_rel, line=fn.lineno,
                message=(f"{fn.name}() packs an engine count but its int32 "
                         f"guard never sees it: N windows span base + "
                         f"N*wset blocks"),
                hint=(f"pass {_ENGINE_PARAM} to the int32 guard in "
                      f"{fn.name}()")))
    return findings


# -------------------------------------------------------- operand shapes
@dataclasses.dataclass(frozen=True)
class OperandShape:
    """A flat ``int32[length]`` operand, or an ``int32[rows, width]``
    table whose first row is a header when `header`."""

    length: Optional[int] = None
    width: Optional[int] = None
    header: bool = False

    def render(self) -> str:
        if self.length is not None:
            return f"int32[{self.length}]"
        return f"int32[{'N+1' if self.header else 'N'}, {self.width}]"

    @property
    def size(self) -> Optional[int]:
        """What the wrappers' named constant gives: the length, or the
        table's row width."""
        return self.length if self.length is not None else self.width


def _local_assign(fn: ast.FunctionDef, name: str) -> Optional[ast.expr]:
    found = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == name:
                    found = node.value
    return found


def _expr_length(expr: ast.expr, fn: ast.FunctionDef,
                 fns: Dict[str, ast.FunctionDef]) -> Optional[int]:
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        first = expr.args[0] if expr.args else None
        if name in ("tensor", "as_tensor", "array") \
                and isinstance(first, (ast.List, ast.Tuple)) \
                and not any(isinstance(e, (ast.List, ast.Tuple, ast.Starred))
                            for e in first.elts):
            return len(first.elts)
        if name in ("cat", "concatenate") \
                and isinstance(first, (ast.List, ast.Tuple)):
            total = 0
            for elt in first.elts:
                part = _expr_length(elt, fn, fns)
                if part is None:
                    return None
                total += part
            return total
        if isinstance(expr.func, ast.Name) and expr.func.id in fns:
            return _packed_length(fns[expr.func.id], fns)
    if isinstance(expr, ast.Name):
        defining = _local_assign(fn, expr.id)
        if defining is not None:
            return _expr_length(defining, fn, fns)
    return None


def _packed_length(fn: ast.FunctionDef,
                    fns: Dict[str, ast.FunctionDef]) -> Optional[int]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            length = _expr_length(node.value, fn, fns)
            if length is not None:
                return length
    return None


def _table_row_width(fn: ast.FunctionDef,
                     fns: Dict[str, ast.FunctionDef]) -> Optional[int]:
    """Row width of a table packer: every flat list literal of >= 2
    elements in the packer and the local helpers it calls (the header and
    the per-engine rows) has it; None when they disagree."""
    widths: Set[int] = set()
    seen = {fn.name}
    stack = [fn]
    while stack:
        cur = stack.pop()
        for node in ast.walk(cur):
            if isinstance(node, ast.List) and len(node.elts) >= 2 \
                    and not any(isinstance(e, (ast.List, ast.Starred))
                                for e in node.elts):
                widths.add(len(node.elts))
        for callee in sorted(_called_names(cur)):
            if callee in fns and callee not in seen:
                seen.add(callee)
                stack.append(fns[callee])
    return widths.pop() if len(widths) == 1 else None


def _table_has_header(fn: ast.FunctionDef) -> bool:
    """The packer returns ``tensor([header] + rows)``: one row on top of
    the per-engine rows."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call) \
                and node.value.args:
            first = node.value.args[0]
            if isinstance(first, ast.BinOp) and isinstance(first.op, ast.Add) \
                    and isinstance(first.left, ast.List) \
                    and len(first.left.elts) == 1:
                return True
    return False


def _packed_shape(fn: ast.FunctionDef, fns: Dict[str, ast.FunctionDef]
                 ) -> Optional[OperandShape]:
    """What an operand packer builds, if statically evident."""
    length = _packed_length(fn, fns)
    if length is not None:
        return OperandShape(length=length)
    width = _table_row_width(fn, fns)
    if width is not None:
        return OperandShape(width=width, header=_table_has_header(fn))
    return None


def _doc_shape(text: str) -> Optional[OperandShape]:
    """``4`` -> int32[4]; ``N+1, 4`` / ``num_engines + 1, 4`` ->
    int32[N+1, 4]; anything else None."""
    parts = [p.strip() for p in text.split(",")]
    if len(parts) == 1 and parts[0].isdigit():
        return OperandShape(length=int(parts[0]))
    if len(parts) == 2 and parts[1].isdigit():
        return OperandShape(width=int(parts[1]),
                            header=bool(re.search(r"\+\s*1$", parts[0])))
    return None


def _doc_findings(fn: ast.FunctionDef, path: str, packer: str,
                  shape: OperandShape) -> List[Finding]:
    findings = []
    for match in _DOC_SHAPE.finditer(ast.get_docstring(fn) or ""):
        declared = _doc_shape(match.group(1))
        if declared is not None and declared != shape:
            findings.append(Finding(
                invariant="REPRO-K003", path=path, line=fn.lineno,
                message=(f"{fn.name}() documents an {declared.render()} "
                         f"operand but {packer}() packs {shape.render()}"),
                hint="update the docstring or the packing together"))
    return findings


def _reads_name(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def check_operand_shapes(ops_path: Path, wrapper_paths: Sequence[Path], *,
                         repo_root: Optional[Path] = None) -> List[Finding]:
    """K003: each packer's shape against the named length the wrappers
    check its operand against, that constant against a comparison that
    reads it, and the docstrings of the packer, of the functions that read
    the constant and of their callers against the shape."""
    ops_rel = _rel(ops_path, repo_root)
    fns = module_functions(parse_module(ops_path))
    wrappers = [(path, parse_module(path)) for path in wrapper_paths]
    constants = {target.id: (int_const(node.value), path)
                 for path, tree in wrappers for node in tree.body
                 if isinstance(node, ast.Assign)
                 for target in node.targets if isinstance(target, ast.Name)}
    findings: List[Finding] = []
    for fn in _packers(fns):
        shape = _packed_shape(fn, fns)
        if shape is None:
            findings.append(Finding(
                invariant="REPRO-K003", path=ops_rel, line=fn.lineno,
                message=(f"operand packer {fn.name}() packs a shape the "
                         f"analyzer cannot resolve statically"),
                hint=("build the operand from literal torch.tensor/"
                      "torch.cat lists (or same-width literal rows) so "
                      "its shape is statically evident")))
            continue
        findings += _doc_findings(fn, ops_rel, fn.name, shape)
        const = OPERAND_LENGTHS.get(fn.name)
        if const is None or const not in constants:
            findings.append(Finding(
                invariant="REPRO-K003", path=ops_rel, line=fn.lineno,
                message=(f"{fn.name}() packs {shape.render()} but no kernel "
                         f"wrapper defines "
                         f"{const or 'a named length for it'}"),
                hint=("name the length in the wrapper module that unpacks "
                      "the operand, and map the packer to it in "
                      "analysis.kernel_shapes.OPERAND_LENGTHS")))
            continue
        value, const_path = constants[const]
        const_rel = _rel(const_path, repo_root)
        if value != shape.size:
            findings.append(Finding(
                invariant="REPRO-K003", path=const_rel, line=1,
                message=(f"{fn.name}() packs {shape.render()} but "
                         f"{const_rel} sets {const} = {value}"),
                hint=f"change the packing and {const} together"))
        readers = [(path, f) for path, tree in wrappers
                   for f in module_functions(tree).values()
                   if _reads_name(f, const)]
        if not any(isinstance(node, ast.Compare) and _reads_name(node, const)
                   for _, f in readers for node in ast.walk(f)):
            findings.append(Finding(
                invariant="REPRO-K003", path=const_rel, line=1,
                message=(f"no kernel wrapper checks an operand against "
                         f"{const}"),
                hint=(f"compare the unpacked operand's length with {const} "
                      f"before launching")))
        names = {f.name for _, f in readers}
        for path, tree in wrappers:
            for f in module_functions(tree).values():
                if f.name in names or _called_names(f) & names:
                    findings += _doc_findings(f, _rel(path, repo_root),
                                              fn.name, shape)
    return findings


# ------------------------------------------------------ working buffers
def _reads_base(modules: _Modules, path: Path, fn: ast.FunctionDef,
                seen: Set[Tuple[Path, str]]) -> bool:
    """`fn`, or a function it calls in its module or imports from the
    tree, reads an ``.a`` (the RST base) attribute."""
    seen.add((path, fn.name))
    if any(isinstance(node, ast.Attribute) and node.attr == "a"
           for node in ast.walk(fn)):
        return True
    for callee in sorted(_called_names(fn)):
        found = modules.resolve(path, callee)
        if found is not None and (found[0], found[1].name) not in seen \
                and _reads_base(modules, *found, seen):
            return True
    return False


def check_working_buffers(ops_path: Path, *,
                          repo_root: Optional[Path] = None
                          ) -> List[Finding]:
    """K004: every working-buffer maker accounts for the base ``p.a``."""
    modules = _Modules()
    ops_rel = _rel(ops_path, repo_root)
    fns = module_functions(modules.tree(ops_path))
    findings: List[Finding] = []
    for name in BUFFER_MAKERS:
        fn = fns.get(name)
        if fn is None:
            findings.append(Finding(
                invariant="REPRO-K004", path=ops_rel, line=1,
                message=f"working-buffer maker {name}() not found",
                hint=("update analysis.kernel_shapes.BUFFER_MAKERS to "
                      "the makers the kernels' callers use")))
        elif not _reads_base(modules, ops_path, fn, set()):
            findings.append(Finding(
                invariant="REPRO-K004", path=ops_rel, line=fn.lineno,
                message=(f"{name}() sizes the buffer without the RST base "
                         f"address A — the kernels address base_block + "
                         f"window blocks, so any A != 0 reads past the "
                         f"buffer"),
                hint=(f"size the buffer over p.a + num_engines * p.w "
                      f"bytes in {name}()")))
    return findings


# ------------------------------------------------------------ dtype codes
def _c_constants(paths: Iterable[Path]) -> Dict[str, Tuple[int, Path]]:
    """``constexpr int kName = value;`` of the C sources: name -> (value,
    file)."""
    out: Dict[str, Tuple[int, Path]] = {}
    for path in paths:
        for name, value in _C_CONSTANT.findall(
                _strip_comments(path.read_text())):
            out.setdefault(name, (int(value), path))
    return out


def check_dtype_codes(codes_path: Path, c_paths: Sequence[Path], *,
                      repo_root: Optional[Path] = None) -> List[Finding]:
    """K005: the wrapper's dtype codes equal the C sources' constants."""
    codes_rel = _rel(codes_path, repo_root)
    constants = _c_constants(c_paths)
    codes: Optional[List[Tuple[str, Optional[int], int]]] = None
    for node in parse_module(codes_path).body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == DTYPE_TABLE
                        for t in node.targets):
            codes = [(key.attr, int_const(value), key.lineno)
                     for key, value in zip(node.value.keys, node.value.values)
                     if isinstance(key, ast.Attribute)]
    if codes is None:
        return [Finding(
            invariant="REPRO-K005", path=codes_rel, line=1,
            message=f"dtype code table {DTYPE_TABLE} not found",
            hint=f"keep {DTYPE_TABLE} a module-level dict of torch dtypes")]
    findings: List[Finding] = []
    for dtype, code, line in codes:
        const = "k" + _DTYPE_C_NAMES.get(dtype, dtype.capitalize())
        if const not in constants:
            findings.append(Finding(
                invariant="REPRO-K005", path=codes_rel, line=line,
                message=(f"{DTYPE_TABLE}[torch.{dtype}] = {code} has no "
                         f"{const} constant in the kernel sources"),
                hint=f"define constexpr int {const} = {code}; in csrc/"))
        elif constants[const][0] != code:
            value, path = constants[const]
            findings.append(Finding(
                invariant="REPRO-K005", path=codes_rel, line=line,
                message=(f"{DTYPE_TABLE}[torch.{dtype}] = {code} but "
                         f"{_rel(path, repo_root)} sets {const} = {value}"),
                hint="make the Python and C dtype codes equal"))
    return findings


# ------------------------------------------------------------ the check
def check_kernel_safety(kernels_dir: Path, *,
                        repo_root: Optional[Path] = None) -> List[Finding]:
    """The whole REPRO-K family over one kernels package: ``ops.py``,
    ``_build.py``, ``rst_read.py`` (the dtype codes), the other wrappers
    and ``csrc/``."""
    ops = kernels_dir / "ops.py"
    csrc = kernels_dir / "csrc"
    findings = check_entry_points(
        kernels_dir / "_build.py", sorted(csrc.glob("*.cu")),
        sorted(kernels_dir.glob("*.py")), repo_root=repo_root)
    findings += check_operand_guards(ops, repo_root=repo_root)
    findings += check_operand_shapes(ops, sorted(kernels_dir.glob("rst_*.py")),
                                     repo_root=repo_root)
    findings += check_working_buffers(ops, repo_root=repo_root)
    findings += check_dtype_codes(kernels_dir / "rst_read.py",
                                  sorted(csrc.glob("*.cu*")),
                                  repo_root=repo_root)
    # One fault seen twice (a docstring stating a shape twice, a typing
    # both in the table and set on its own) reports once.
    unique: Dict[Tuple[str, str, str], Finding] = {}
    for f in findings:
        unique.setdefault(f.key, f)
    return list(unique.values())
