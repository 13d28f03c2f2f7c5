"""Repo-idiom lint, the port's counterpart of ``repro.analysis.lint``: the
same AST walk over the port's Python, plus one rule over its CUDA sources.

* ``traced-param-branch`` — a Python ``if``/``while``/``assert`` on a
  ``MechParams``/``WorkloadParams`` leaf inside step code.  Every such leaf
  is a tensor, so the branch reads it back to the host once per step.
* ``unmasked-padded-reduction`` — a torch reduction (``min``/``amin``/
  ``argmin``/``max``/``sum``/...) over one of the padded FTS *value* fields
  (``benefit``/``last_use``/``row_sum``) that is not routed through
  ``masked_argmin``/``torch.where``.  Padding lanes hold 0, which wins an
  unmasked min and silently corrupts victim selection.
* ``numpy-in-scan-body`` — numpy, ``.item()``, ``.tolist()``, ``.cpu()`` or
  ``.numpy()`` in step code: each is a host sync per step, the failure the
  replay kernel exists to avoid.
* ``kernel-load-in-call`` (the JAX package's ``jit-closure-cache``) — a
  ``ctypes.CDLL(...)`` outside ``kernels/_build.py``: it opens the library
  again on every call, bypassing ``_build``'s once-per-process cache.
* ``smem-budget`` (the JAX package's ``pallas-vmem-budget``) — in
  ``csrc/*.cu``, a ``__global__`` kernel whose statically-resolvable
  ``__shared__`` arrays plus a literal or ``constexpr``
  ``cudaFuncAttributeMaxDynamicSharedMemorySize`` exceed the H100's
  per-block opt-in limit.  Sizes that do not resolve are skipped rather
  than guessed.

"Step code" is detected syntactically, as in the JAX package: functions
defined inside a ``make_*``/``_make_*`` factory (the repo's step-factory
convention) and anything nested in one of those.  A ``# repro:
allow(<rule>)`` pragma (``// repro: allow(<rule>)`` in CUDA) on the line
or the one above opts one site out.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis import findings as F

# ---------------------------------------------------------------------------
# rule registry

RULES: Dict[str, str] = {}          # id -> short description
_CHECKS: List[Tuple[str, Callable]] = []


def rule(rid: str, desc: str):
    def deco(fn):
        RULES[rid] = desc
        _CHECKS.append((rid, fn))
        return fn
    return deco


# port rule -> the JAX package's rule it stands for
RENAMED = {"kernel-load-in-call": "jit-closure-cache",
           "smem-budget": "pallas-vmem-budget"}

NOT_PORTED = {
    "pallas-io-alias": "the CUDA wrappers have no alias table to check: "
                       "each passes the data_ptr() of the in-place leaf "
                       "itself and checks its shape, dtype and contiguity "
                       "in pack() before the launch, so an input and its "
                       "output are one buffer by construction",
}


def _traced_fields() -> set:
    """The fields a Python branch must never touch, read from the live
    NamedTuples so the lint cannot drift from the code."""
    from repro_torch.core.timing import MechParams
    from repro_torch.core.workload import WorkloadParams
    return set(MechParams._fields) | set(WorkloadParams._fields)


TRACED_TYPES = {"MechParams", "WorkloadParams"}
PADDED_VALUE_FIELDS = {"benefit", "last_use", "row_sum"}
REDUCTIONS = {"argmin", "argmax", "min", "max", "amin", "amax", "sum",
              "prod", "aminmax"}
MASK_HELPERS = {"where", "masked_argmin", "masked_fill", "select"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
SMEM_LIMIT_BYTES = 232448    # 227 KiB: the H100's per-block opt-in limit
_LOADER = os.path.join("kernels", "_build.py")


# ---------------------------------------------------------------------------
# per-module context

@dataclasses.dataclass
class Module:
    path: str                       # repo-relative
    src_lines: List[str]
    tree: ast.Module
    parents: Dict[ast.AST, ast.AST]
    traced_fns: set                 # FunctionDef/Lambda nodes of step code
    np_aliases: set                 # local names bound to the numpy module
    torch_aliases: set              # local names bound to torch

    def finding(self, rid: str, node: ast.AST, msg: str,
                level: str = F.ERROR) -> Optional[F.Finding]:
        line = getattr(node, "lineno", None)
        if line is not None and rid in F.allowed_rules(self.src_lines, line):
            return None
        return F.Finding(rule=rid, message=msg, level=level,
                         path=self.path, line=line)


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _collect_aliases(tree: ast.Module) -> Tuple[set, set]:
    np_names, torch_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                tgt = a.asname or a.name.split(".")[0]
                if a.name == "numpy":
                    np_names.add(tgt)
                elif a.name == "torch":
                    torch_names.add(tgt)
    return np_names, torch_names or {"torch"}


def _traced_functions(tree: ast.Module) -> set:
    """Step code: every function nested in a ``make_*`` factory."""
    traced = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith(("make_", "_make_")):
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                    traced.add(sub)
    return traced


def load_module(path: str, repo_root: str = ".") -> Optional[Module]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=path)
    except (OSError, SyntaxError):
        return None
    rel = os.path.relpath(path, repo_root)
    np_a, torch_a = _collect_aliases(tree)
    return Module(path=rel, src_lines=src.splitlines(), tree=tree,
                  parents=_parent_map(tree),
                  traced_fns=_traced_functions(tree),
                  np_aliases=np_a, torch_aliases=torch_a)


# ---------------------------------------------------------------------------
# rules

def _traced_names(fn) -> set:
    """Parameters annotated as a traced-params NamedTuple, and local names
    assigned straight from one (``p = params``)."""
    names = set()
    args = fn.args
    for a in list(args.args) + list(args.kwonlyargs) + list(
            args.posonlyargs):
        ann = a.annotation
        if ann is not None and _dotted(ann).split(".")[-1] in TRACED_TYPES:
            names.add(a.arg)
    changed = bool(names)
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in names \
                    and node.targets[0].id not in names:
                names.add(node.targets[0].id)
                changed = True
    return names


@rule("traced-param-branch",
      "MechParams/WorkloadParams leaf in a Python branch in step code")
def _check_traced_branch(mod: Module) -> Iterable[F.Finding]:
    fields = _traced_fields()
    for fn in mod.traced_fns:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        traced = _traced_names(fn)
        if not traced:
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                yield from _traced_attrs_in(node.test, traced, fields, mod)


def _traced_attrs_in(test: ast.AST, traced: set, fields: set,
                     mod: Module) -> Iterable[F.Finding]:
    # skip `x.attr is None` / `is not None` shape-vs-None dispatch
    skip = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            skip.update(ast.walk(node))
    for node in ast.walk(test):
        if node in skip or not isinstance(node, ast.Attribute):
            continue
        if isinstance(node.value, ast.Name) \
                and node.value.id in traced and node.attr in fields:
            f = mod.finding(
                "traced-param-branch", node,
                f"tensor leaf `{node.value.id}.{node.attr}` in a Python "
                f"branch/assert in step code reads it back to the host every "
                f"step; use torch.where (or move the knob to StaticConfig)")
            if f:
                yield f


def _masked_between(mod: Module, leaf: ast.AST, top: ast.AST) -> bool:
    """A mask helper call sits between ``leaf`` and the reduction ``top``."""
    cur = leaf
    while cur is not top and cur in mod.parents:
        cur = mod.parents[cur]
        if isinstance(cur, ast.Call):
            callee = cur.func
            nm = callee.attr if isinstance(callee, ast.Attribute) \
                else _dotted(callee)
            if nm in MASK_HELPERS:
                return True
    return False


@rule("unmasked-padded-reduction",
      "torch reduction over a padded FTS value field without mask routing")
def _check_padded_reduction(mod: Module) -> Iterable[F.Finding]:
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in REDUCTIONS):
            continue
        base = node.func.value
        if isinstance(base, ast.Name) and base.id in mod.torch_aliases:
            operands = list(node.args)        # torch.argmin(x, ...)
        else:
            operands = [base]                 # x.argmin(...)
        for arg in operands:
            for attr in ast.walk(arg):
                if not (isinstance(attr, ast.Attribute)
                        and attr.attr in PADDED_VALUE_FIELDS):
                    continue
                if _masked_between(mod, attr, node):
                    continue
                f = mod.finding(
                    "unmasked-padded-reduction", node,
                    f"{node.func.attr} over padded field `.{attr.attr}` "
                    f"without masked_argmin/torch.where; padding slots hold "
                    f"0 and win unmasked reductions")
                if f:
                    yield f


@rule("numpy-in-scan-body",
      "host numpy call or host read-back (.item/.tolist/.cpu/.numpy) in "
      "step code")
def _check_numpy_in_step(mod: Module) -> Iterable[F.Finding]:
    for fn in mod.traced_fns:
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in mod.np_aliases:
                f = mod.finding(
                    "numpy-in-scan-body", node,
                    f"host `{node.value.id}.{node.attr}` in step code; use "
                    f"torch ops on the lanes' device (host numpy forces a "
                    f"sync per step)")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in HOST_METHODS and not node.args:
                f = mod.finding(
                    "numpy-in-scan-body", node,
                    f"`.{node.func.attr}()` in step code copies a device "
                    f"value to the host every step")
            else:
                continue
            if f:
                yield f


@rule("kernel-load-in-call",
      "ctypes library opened outside kernels/_build.py (bypasses its "
      "once-per-process cache)")
def _check_kernel_load(mod: Module) -> Iterable[F.Finding]:
    if mod.path.endswith(_LOADER):
        return
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and _dotted(node.func) in (
                "ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary",
                "cdll.LoadLibrary"):
            f = mod.finding(
                "kernel-load-in-call", node,
                "ctypes opens the library on every call here; go through "
                "kernels/_build.py's load / load_host, which open each "
                "library once per process")
            if f:
                yield f


# ---- CUDA sources -----------------------------------------------------------

_CTYPE_BYTES = {"char": 1, "int8_t": 1, "uint8_t": 1, "bool": 1,
                "unsigned char": 1, "int16_t": 2, "uint16_t": 2, "half": 2,
                "__half": 2, "__nv_bfloat16": 2, "int": 4, "int32_t": 4,
                "uint32_t": 4, "unsigned": 4, "float": 4, "int64_t": 8,
                "uint64_t": 8, "double": 8, "float2": 8, "float4": 16,
                "int4": 16}
_CONSTEXPR_RE = re.compile(
    r"constexpr\s+(?:int|unsigned|size_t|int32_t|int64_t|uint32_t)\s+"
    r"(\w+)\s*=\s*([^;]+);")
_SHARED_RE = re.compile(
    r"(?<!extern )__shared__\s+(?:alignas\(\d+\)\s+|__align__\(\d+\)\s+)?"
    r"((?:unsigned )?\w+)\s+(\w+)((?:\s*\[[^\]]+\])*)\s*;")
_GLOBAL_RE = re.compile(r"__global__\s+(?:void\s+)?"
                        r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
_ATTR_RE = re.compile(
    r"cudaFuncSetAttribute\(\s*([\w:<>]+?)(?:<[^>]*>)?\s*,\s*"
    r"cudaFuncAttributeMaxDynamicSharedMemorySize\s*,\s*([^;]+?)\)\s*;",
    re.S)


_C_OPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
          ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a // b,
          ast.FloorDiv: lambda a, b: a // b, ast.LShift: lambda a, b: a << b,
          ast.RShift: lambda a, b: a >> b}


def _eval_c(expr: str, env: Dict[str, int]) -> Optional[int]:
    """An integer C expression of literals, known constants, ``+ - * / <<
    >>`` and parentheses (which parse as Python), or None."""
    expr = re.sub(r"\b(\d+)[uUlL]+\b", r"\1", expr.strip())
    try:
        tree = ast.parse(expr, mode="eval").body
    except SyntaxError:
        return None

    def ev(node) -> Optional[int]:
        if isinstance(node, ast.Constant) and type(node.value) is int:
            return node.value
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.BinOp) and type(node.op) in _C_OPS:
            a, b = ev(node.left), ev(node.right)
            if a is None or b is None or (b == 0 and isinstance(
                    node.op, (ast.Div, ast.FloorDiv))):
                return None
            return _C_OPS[type(node.op)](a, b)
        return None

    return ev(tree)


def _cuda_consts(text: str) -> Dict[str, int]:
    env: Dict[str, int] = {}
    for name, expr in _CONSTEXPR_RE.findall(text):
        val = _eval_c(expr, env)
        if val is not None:
            env[name] = val
    return env


def _body_end(text: str, start: int) -> int:
    """Index just past the brace block that opens at or after ``start``."""
    i = text.find("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return j + 1
    return len(text)


# over CUDA sources, not Python modules: lint_paths calls it directly
RULES["smem-budget"] = ("statically-resolvable shared memory of a CUDA "
                        "kernel above the H100's per-block limit")


def smem_findings(path: str, text: str) -> List[F.Finding]:
    """``smem-budget`` over one CUDA source's text."""
    env = _cuda_consts(text)
    lines = text.splitlines()
    dynamic: Dict[str, Optional[int]] = {}
    for name, expr in _ATTR_RE.findall(text):
        val = _eval_c(expr, env)
        kernel = name.split("<")[0]
        prev = dynamic.get(kernel, 0)
        dynamic[kernel] = None if val is None or prev is None \
            else max(prev, val)
    out = []
    for m in _GLOBAL_RE.finditer(text):
        body = text[m.end():_body_end(text, m.end())]
        total: Optional[int] = dynamic.get(m.group(1), 0)
        for ctype, _name, dims in _SHARED_RE.findall(body):
            size = _CTYPE_BYTES.get(ctype)
            for d in re.findall(r"\[([^\]]+)\]", dims):
                n = _eval_c(d, env)
                size = None if size is None or n is None else size * n
            total = None if size is None or total is None else total + size
        if total is None or total <= SMEM_LIMIT_BYTES:
            continue                  # unresolvable: no guess, no finding
        line = text.count("\n", 0, m.start()) + 1
        if "smem-budget" in F.allowed_rules(lines, line):
            continue
        out.append(F.Finding(
            rule="smem-budget", path=path, line=line,
            message=f"kernel `{m.group(1)}` asks for {total} B of shared "
                    f"memory a block (static arrays plus the dynamic "
                    f"attribute) against the H100's {SMEM_LIMIT_BYTES} B; "
                    f"shrink its tiles or stage through registers"))
    return out


# ---------------------------------------------------------------------------
# the pass

DEFAULT_PATHS = tuple(f"src/repro_torch/{d}" for d in
                      ("core", "kernels", "analysis", "launch", "obs",
                       "csrc"))


def iter_files(paths: Iterable[str], repo_root: str = ".",
               suffixes: Tuple[str, ...] = (".py", ".cu")) -> List[str]:
    out = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(repo_root, p)
        if os.path.isfile(full) and full.endswith(suffixes):
            out.append(full)
        elif os.path.isdir(full):
            for dirpath, _dirnames, filenames in os.walk(full):
                out += [os.path.join(dirpath, fn) for fn in sorted(filenames)
                        if fn.endswith(suffixes)]
    return sorted(out)


def lint_paths(paths: Iterable[str] = DEFAULT_PATHS,
               repo_root: str = ".") -> F.Report:
    rep = F.Report(passes=["lint"])
    for path in iter_files(paths, repo_root):
        if path.endswith(".cu"):
            rel = os.path.relpath(path, repo_root)
            rep.scanned.append(rel)
            with open(path, "r", encoding="utf-8") as f:
                rep.extend(smem_findings(rel, f.read()))
            continue
        mod = load_module(path, repo_root)
        if mod is None:
            continue
        rep.scanned.append(mod.path)
        for _rid, check in _CHECKS:
            rep.extend(check(mod))
    return rep

