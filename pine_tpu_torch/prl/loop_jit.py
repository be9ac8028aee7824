"""Compilation of hot host-side PRL loops.  Counterpart of
pine_tpu/prl/loop_jit.py.

The reference compiles whole scripts to native code through LLVM at -O3
(jit.cpp:2219-2354), so compute-heavy scripts like scenes/benchmark.pine run
at C speed.  The eager tree-walk interpreter here detects hot affine ``for``
loops (and long-running ``while`` loops) and hands the whole nest to one of
two tiers:

- **batched tier**: if every outer variable the loop mutates is a pure
  ``+=``/``-=`` reduction, the iterations are independent — run them as
  MAX_LANES-wide slabs of lanes (the loop variable an int32 tensor; the body
  runs through the evaluator over those lanes, data-dependent inner loops
  as trace_flow.py's masked loops) and add up the masked per-lane deltas
  afterwards, exactly (int64) for integers.  The lanes live on the
  interpreter's device (benchmark.pine runs 1.3-2.5x faster with them on an
  H100 at 700 W than on its host's CPU, PERF.md; chip_smoke.py times both).
- **sequential tier**: otherwise the loop's AST is lowered once to a Python
  function over the loop's variables (``_Lowering``: Python locals in
  place of the interpreter's environment cells, each operator on two
  scalars known to be ints or floats written as the Python operator the
  evaluator applies, every other one a call of the evaluator's own
  operator), so it runs with the eager interpreter's exact semantics at a
  fraction of its cost.  It runs on the host.

A conservative purity pre-scan gates compilation: only whitelisted math
builtins and user ``fn``s with pure bodies; no break/continue/return, no
lambdas, no prints, no RNG, no scene mutation.  Anything else, or a PRL
runtime error while running a tier (a traced loop the lanes cannot take, a
value that changes type; the environment is left as it was), falls back to
the unchanged eager path; torch's and CUDA's own errors propagate.  Compiled tiers are cached per loop
AST node; every outer value the body reads is passed as an argument, so a
re-run never bakes stale state (a called ``fn`` runs with its live closure).

Set PINE_NO_LOOPJIT=1 to disable, PINE_LOOPJIT_DEBUG=1 to log bail reasons.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from pine_tpu_torch.prl import ast as A
from pine_tpu_torch.prl.trace_flow import assigned_names
from pine_tpu_torch.prl.trace_flow import children as _children
from pine_tpu_torch.prl.values import PrlMat, PrlVec

MIN_TRIP = 4096          # below this, eager interpretation beats a compile
MAX_LANES = 65536        # slab width for the batched tier
SMALL_NESTED_TRIP = 64   # nested literal for-loops up to this run inside a tier
WHILE_HOT_ITERS = 20000  # eager while iterations before a compile attempt

PURE_BUILTINS = frozenset(
    (
        "min max abs clamp lerp sqr sqrt fract floor ceil powi pow exp log2 "
        "log log10 sin cos tan acos asin sinh cosh tanh atan2 normalize "
        "length distance dot cross sum max_value min_value max_axis min_axis "
        "mat2 mat3 mat4 identity3x3 identity4x4 transpose determinant "
        "inverse solve rotate_x rotate_y rotate_z rotate translate scale "
        "look_at lookat coordinate_system spherical_to_cartesian "
        "unit_square_to_cartesian cartesian_to_spherical "
        "cartesian_to_unit_square sample_disk_polar sample_disk_concentric "
        "cosine_weighted_hemisphere uniform_sphere uniform_hemisphere "
        "inverse_uniform_sphere inverse_uniform_hemisphere pnoise pnoise2d "
        "pnoise3d fbm fbm2d fbm3d"
    ).split()
)

_CACHE = {}     # id(loop node) -> {"node": node, "env": [env], key: compiled tier}
_ACTIVE = [False]  # re-entrancy guard: no compile attempts inside a compiled tier
RUNS = {"batch": 0, "seq": 0}  # loops each tier ran to their end (chip_smoke.py reads it)


class _Bail(Exception):
    pass


def _debug(msg):
    if os.environ.get("PINE_LOOPJIT_DEBUG"):
        print(f"[loop_jit] {msg}")


def _disabled():
    return bool(os.environ.get("PINE_NO_LOOPJIT"))


# ---------------------------------------------------------------------------
# AST walking
# ---------------------------------------------------------------------------

def _referenced(node, out):
    """All Id / Call names mentioned anywhere under `node`."""
    if isinstance(node, A.Id) or isinstance(node, A.Call):
        out.add(node.name)
    for c in _children(node):
        _referenced(c, out)
    return out


def _is_pure_reduction(body, nm):
    """True iff `nm` appears ONLY as the direct target of statement-level
    `nm += e` / `nm -= e` (so its in-loop value is never read and the lane
    deltas combine by summation)."""
    ok = [True]

    def visit(node, parent, grand):
        if isinstance(node, A.Id) and node.name == nm:
            good = (
                isinstance(parent, A.Binary)
                and parent.op in ("+=", "-=")
                and parent.a is node
                and isinstance(grand, A.ExprStmt)
            )
            if not good:
                ok[0] = False

    def walk(node, parent=None, grand=None):
        visit(node, parent, grand)
        for c in _children(node):
            walk(c, node, parent)

    walk(body)
    return ok[0]


# ---------------------------------------------------------------------------
# purity pre-scan
# ---------------------------------------------------------------------------

def _static_trip(node):
    """Trip count of a For when init/cond/inc are all integer literals."""
    info = _affine(node)
    if info is None:
        return None
    _, begin_e, end_e, step_e, strict = info
    vals = []
    for e in (begin_e, end_e):
        if not (isinstance(e, A.NumLit) and isinstance(e.value, int)):
            return None
        vals.append(e.value)
    if step_e is None:
        step = 1
    elif isinstance(step_e, A.NumLit) and isinstance(step_e.value, int):
        step = step_e.value
    else:
        return None
    if step <= 0:
        return None
    begin, end = vals
    return _trip_count(begin, end, step, strict)


def _trip_count(begin, end, step, strict):
    span = end - begin
    if strict:
        return max(0, -(-span // step))
    return max(0, span // step + 1)


def _scan_pure(interp, env, node, seen_fns, in_fn=False, loop_depth=0):
    """Raise _Bail unless `node` is safe to run in a tier (no side effects)
    and lowerable (no unsupported control flow).

    `return` is fine inside a *called fn* (ReturnEx stays within the call);
    directly in the compiled loop body it would exit the enclosing scope.
    `break`/`continue` are fine inside a nested loop but not at the compiled
    loop's own level."""
    k = type(node)
    if k is A.ReturnStmt and not in_fn:
        raise _Bail("ReturnStmt in loop body")
    if k in (A.BreakStmt, A.ContinueStmt) and loop_depth == 0:
        raise _Bail(f"{k.__name__} at compiled-loop level")
    if k in (A.FnDef, A.ClassDef, A.Lambda):
        raise _Bail(f"{k.__name__} in loop body")
    if k is A.For:
        t = _static_trip(node)
        if t is None or t > SMALL_NESTED_TRIP:
            raise _Bail("nested for-loop is not small/literal")
    if k is A.Call:
        _scan_callee(interp, env, node.name, seen_fns)
    child_depth = loop_depth + 1 if k in (A.For, A.While) else loop_depth
    for c in _children(node):
        _scan_pure(interp, env, c, seen_fns, in_fn, child_depth)


def _scan_callee(interp, env, name, seen_fns):
    from pine_tpu_torch.prl.interp import PrlFunction

    cell = env.find(name)
    if cell is not None:
        v = cell.get()
        if isinstance(v, PrlFunction):
            if v not in seen_fns:
                seen_fns.add(v)
                _scan_pure(interp, v.env, v.node.body, seen_fns, in_fn=True)
            return
        raise _Bail(f"call target `{name}` is not a pure fn")
    if name in PURE_BUILTINS:
        return
    raise _Bail(f"call to non-whitelisted `{name}`")


# ---------------------------------------------------------------------------
# loop shape analysis
# ---------------------------------------------------------------------------

def _affine(node):
    """Match `for (v := begin; v < end; ++v | v += step)`; both PRL range
    forms desugar to exactly this (parser.for_)."""
    init, cond, inc = node.init, node.cond, node.inc
    if not (isinstance(init, A.Decl) and init.kind == "declare"):
        return None
    name = init.name
    if not (
        isinstance(cond, A.Binary)
        and cond.op in ("<", "<=")
        and isinstance(cond.a, A.Id)
        and cond.a.name == name
    ):
        return None
    if (
        isinstance(inc, A.Unary)
        and inc.op == "preinc"
        and isinstance(inc.e, A.Id)
        and inc.e.name == name
    ):
        step_e = None
    elif (
        isinstance(inc, A.Binary)
        and inc.op == "+="
        and isinstance(inc.a, A.Id)
        and inc.a.name == name
    ):
        step_e = inc.b
    else:
        return None
    return name, init.expr, cond.b, step_e, cond.op == "<"


def _concrete_int(v):
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, np.integer)):
        return int(v)
    return None


def _leaf_kind(v):
    """Classify a concrete value for carries and reads; None if not
    compilable (lane tensors, objects, strings)."""
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, PrlVec) and isinstance(v.data, np.ndarray):
        return "veci" if v.is_int else "vec"
    if isinstance(v, PrlMat) and isinstance(v.data, np.ndarray):
        return "mat"
    return None


def _classify(env, body, loopvar):
    """Split mutated names into loop-locals / reductions / carries."""
    names = assigned_names(body)
    names.discard(loopvar)
    reds, carries = [], []
    for nm in sorted(names):
        cell = env.find(nm)
        if cell is None:
            continue  # created fresh in the body's block scope each iteration
        kind = _leaf_kind(cell.get())
        if kind is None:
            raise _Bail(f"`{nm}` mutated but not a compilable value")
        if kind in ("int", "float", "vec", "veci") and _is_pure_reduction(body, nm):
            reds.append((nm, kind))
        else:
            carries.append((nm, kind))
    return reds, carries


def _collect_reads(interp, env, nodes, exclude):
    """Outer values the body reads -> passed as arguments.  Returns (read
    specs, resolved-fn id tuple for the cache key)."""
    from pine_tpu_torch.prl.interp import PrlFunction

    refs = set()
    for n in nodes:
        _referenced(n, refs)
    reads, fn_ids = [], []
    for nm in sorted(refs - exclude):
        cell = env.find(nm)
        if cell is None:
            continue  # builtin (purity scan already vetted calls)
        v = cell.get()
        if isinstance(v, PrlFunction):
            fn_ids.append((nm, id(v)))
            continue
        kind = _leaf_kind(v)
        if kind is None:
            raise _Bail(f"read of non-compilable `{nm}`")
        reads.append((nm, kind))
    return reads, tuple(fn_ids)


def _combine_reduction(init, kind, total):
    if kind == "int":
        return int(init) + int(total)
    if kind == "float":
        return float(init) + float(total)
    data = np.asarray(init.data)
    return PrlVec((data + total).astype(data.dtype), kind == "veci")


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------

def _entry_for(node, env):
    entry = _CACHE.get(id(node))
    if entry is None or entry["node"] is not node:
        entry = {"node": node, "env": [env]}
        _CACHE[id(node)] = entry
    entry["env"][0] = env
    return entry


def _batched_device(interp):
    from pine_tpu_torch.core.place import resolve_device

    return resolve_device(interp.device)


def _run_batched(interp, node, env, loopvar, begin, end, step, strict, trip,
                 reds, reads, fn_ids):
    """The iterations as lanes, MAX_LANES a slab; the reductions' masked
    per-lane deltas added up exactly (int64, float64) on the lanes' device,
    then onto the outer values once."""
    from pine_tpu_torch.prl.interp import Env

    lanes = min(trip, MAX_LANES)
    dev = _batched_device(interp)
    entry = _entry_for(node, env)
    key = ("batch", lanes, step, strict, tuple(reds), tuple(reads), fn_ids, str(dev))
    entry[key] = True
    red_cells = [(env.find(nm), kind) for nm, kind in reds]
    inits = [c.get() for c, _ in red_cells]
    last = begin + step * (trip - 1)
    totals = None
    for s in range(0, trip, lanes):
        scope = Env(env)
        i = begin + s * step + step * torch.arange(lanes, dtype=torch.int32, device=dev)
        valid = (i < end) if strict else (i <= end)
        # inert lanes repeat the last real iteration (keeps inner
        # data-dependent loops terminating); their deltas are masked out
        i = torch.where(valid, i, torch.full_like(i, last))
        scope.declare(loopvar, i)
        cells = [scope.declare(nm, _zero_delta(kind, cell.get())) for (cell, kind), (nm, _)
                 in zip(red_cells, reds)]
        interp.exec_block(node.body, scope)
        outs = []
        for c, (_, kind) in zip(cells, red_cells):
            d = c.get()
            raw = torch.as_tensor(d.data if isinstance(d, PrlVec) else d, device=dev)
            want = (lanes,) if kind in ("int", "float") else (lanes, raw.shape[-1])
            raw = raw.expand(want)
            m = valid if raw.ndim == 1 else valid[:, None]
            acc = torch.int64 if kind in ("int", "veci") else torch.float64
            outs.append(torch.where(m, raw, 0).to(acc).sum(0))
        totals = outs if totals is None else [a + b for a, b in zip(totals, outs)]
    for (cell, kind), init, tot in zip(red_cells, inits, totals or []):
        cell.set(_combine_reduction(init, kind, tot.cpu().numpy()))
    RUNS["batch"] += 1


def _zero_delta(kind, v):
    if kind == "int":
        return 0
    if kind == "float":
        return 0.0
    return PrlVec(np.zeros(v.n, np.int32 if kind == "veci" else np.float32), kind == "veci")


def _run_sequential(interp, node, env, cond_node, body, inc_node,
                    shadow, reads, fn_ids, loop_init=None):
    """The loop lowered to a Python function of its carried `shadow` (name,
    kind) values and its reads; `loop_init` = (loopvar, begin) for For
    loops, None for While.  The environment changes only once it returns."""
    entry = _entry_for(node, env)
    key = ("seq", tuple(shadow), tuple(reads), fn_ids,
           None if loop_init is None else loop_init[0])
    fn = entry.get(key)
    if fn is None:
        fn = _Lowering(interp, env, shadow, reads, loop_init).compile(
            cond_node, body, inc_node)
        entry[key] = fn
    shadow_cells = [env.find(nm) for nm, _ in shadow]
    args = [c.get() for c in shadow_cells] + [env.find(nm).get() for nm, _ in reads]
    if loop_init is not None:
        args.append(loop_init[1])
    outs = fn(*args)
    for cell, o in zip(shadow_cells, outs):
        cell.set(o)
    RUNS["seq"] += 1


class _Lowering:
    """A loop's AST as the source of a Python function: PRL variables become
    Python locals ``v_<name>``, statements Python statements.  An operator on
    two values whose kinds are known to be int or float (from the values at
    entry and the literals, through every assignment) is the Python operator
    the evaluator would apply to them (ops._scalar_op); ``/`` and ``%`` call
    ops._c_div / ops._c_mod; anything else calls ops.binary, ops.unary, the
    builtin, the script fn or the member and subscript dispatch the
    evaluator calls.  Block scopes flatten into the function's locals, so a
    body that declares (``:=``) a name the loop also sees outside bails."""

    SCALAR_OPS = ("+", "-", "*", "<", ">", "<=", ">=", "==", "!=")

    def __init__(self, interp, env, shadow, reads, loop_init):
        from pine_tpu_torch.prl import ops

        self.interp = interp
        self.env = env
        self.outer = [nm for nm, _ in shadow] + [nm for nm, _ in reads]
        self.params = list(self.outer) + ([loop_init[0]] if loop_init is not None else [])
        self.kinds = {nm: k for nm, k in list(shadow) + list(reads)}
        if loop_init is not None:
            self.kinds[loop_init[0]] = "int"
        self.shadow = [nm for nm, _ in shadow]
        self.ns = {"_B": ops.binary, "_U": ops.unary, "_cdiv": ops._c_div, "_cmod": ops._c_mod,
                   "_idiv": _idiv, "_imod": _imod,
                   "_mget": interp.member_get, "_sget": interp.subscript_get}
        self.names = {}  # object -> its name in ns

    # ---- helpers ----
    def _obj(self, obj, hint):
        key = id(obj)
        if key not in self.names:
            nm = f"_{hint}{len(self.names)}"
            self.names[key] = nm
            self.ns[nm] = obj
        return self.names[key]

    def _assign(self, name, kind):
        old = self.kinds.get(name, "unset")
        new = kind if old in ("unset", kind) else None
        if new != old:
            self.changed = True
        self.kinds[name] = new

    def compile(self, cond, body, inc):
        from pine_tpu_torch.prl.values import make_vec
        from pine_tpu_torch.prl.interp import _copy_val

        self.ns.update(_mkvec=make_vec, _copy=_copy_val)
        for _ in range(8):  # the kinds of every variable to a fixed point
            self.changed = False
            self.lines = []
            self._loop(cond, body, inc, 1)
            if not self.changed:
                break
        else:
            raise _Bail("variable kinds did not settle")
        src = [f"def _loop({', '.join('v_' + p for p in self.params)}):"]
        src += self.lines
        src.append(f"    return ({''.join('v_' + n + ', ' for n in self.shadow)})")
        exec(compile("\n".join(src), "<loop_jit>", "exec"), self.ns)
        return self.ns["_loop"]

    def _emit(self, depth, line):
        self.lines.append("    " * depth + line)

    def _loop(self, cond, body, inc, depth):
        c, _ = self.expr(cond)
        self._emit(depth, f"while {c}:")
        n = len(self.lines)
        self.block(body, depth + 1, in_for=inc is not None)
        if inc is not None:
            self.stmt(A.ExprStmt(inc), depth + 1)
        if len(self.lines) == n:
            self._emit(depth + 1, "pass")

    def block(self, blk, depth, in_for=False):
        n = len(self.lines)
        for e in blk.elems:
            self.stmt(e, depth, in_for)
        if len(self.lines) == n:
            self._emit(depth, "pass")

    def stmt(self, node, depth, in_for=False):
        k = type(node)
        if k is A.ExprStmt:
            self._emit(depth, self.expr(node.expr)[0])
        elif k is A.Decl:
            if node.kind == "ref":
                raise _Bail("reference declaration in loop body")
            if node.kind == "declare" and node.name in self.outer:
                raise _Bail(f"`{node.name}` declared over an outer name")
            e, kind = self.expr(node.expr)
            self._assign(node.name, kind)
            value = e if kind in ("int", "float", "bool") else f"_copy({e})"
            self._emit(depth, f"v_{node.name} = {value}")
        elif k is A.Block:
            self.block(node, depth, in_for)
        elif k is A.While:
            self._loop(node.cond, node.body, None, depth)
        elif k is A.For:
            if _has_continue(node.body):
                raise _Bail("continue in a nested for-loop")
            self.stmt(node.init, depth)
            self._loop(node.cond, node.body, node.inc, depth)
        elif k is A.IfChain:
            for i, (c, blk) in enumerate(zip(node.conds, node.blocks)):
                self._emit(depth, f"{'if' if i == 0 else 'elif'} {self.expr(c)[0]}:")
                self.block(blk, depth + 1, in_for)
            if node.else_block is not None:
                self._emit(depth, "else:")
                self.block(node.else_block, depth + 1, in_for)
        elif k is A.BreakStmt:
            self._emit(depth, "break")
        elif k is A.ContinueStmt:
            if in_for:
                raise _Bail("continue in a for-loop")
            self._emit(depth, "continue")
        else:
            raise _Bail(f"{k.__name__} is not lowered")

    def expr(self, node):
        """-> (Python source, kind: "int", "float", "bool", or None)."""
        k = type(node)
        if k is A.NumLit:
            return repr(node.value), "int" if isinstance(node.value, int) else "float"
        if k is A.BoolLit:
            return repr(bool(node.value)), "bool"
        if k is A.StrLit:
            return repr(node.value), None
        if k is A.Id:
            if node.name in self.kinds:
                return f"v_{node.name}", self.kinds[node.name]
            b = self.interp.builtins.get(node.name)
            if self.env.find(node.name) is None and b is not None and getattr(
                    b, "is_constant", False):
                return f"{self._obj(b, 'b')}()", None
            return f"v_{node.name}", None  # a body-local not assigned yet
        if k is A.VecLit:
            return f"_mkvec([{', '.join(self.expr(e)[0] for e in node.elems)}])", None
        if k is A.Unary:
            return self._unary(node)
        if k is A.Binary:
            return self._binary(node)
        if k is A.Member:
            return f"_mget({self.expr(node.base)[0]}, {node.name!r})", None
        if k is A.Subscript:
            return f"_sget({self.expr(node.base)[0]}, {self.expr(node.index)[0]})", None
        if k is A.Call:
            return self._call(node)
        raise _Bail(f"{k.__name__} is not lowered")

    def _unary(self, node):
        op = node.op
        if op in ("preinc", "predec", "postinc", "postdec"):
            if not isinstance(node.e, A.Id):
                raise _Bail("increment of a member or element")
            nm = node.e.name
            kind = self.kinds.get(nm)
            new = self._arith("+" if "inc" in op else "-", f"v_{nm}", kind, "1", "int")
            self._assign(nm, new[1])
            if op.startswith("pre"):
                return f"(v_{nm} := {new[0]})", new[1]
            return f"(v_{nm}, (v_{nm} := {new[0]}))[0]", kind
        e, kind = self.expr(node.e)
        if op == "pos":
            return e, kind
        if op == "neg" and kind in ("int", "float"):
            return f"(-{e})", kind
        if op == "not" and kind == "bool":
            return f"(not {e})", "bool"
        return f"_U({op!r}, {e})", None

    def _arith(self, op, a, ka, b, kb):
        scalar = ka in ("int", "float") and kb in ("int", "float")
        kind = ("int" if ka == kb == "int" else "float") if scalar else None
        if scalar and op in self.SCALAR_OPS:
            return f"({a} {op} {b})", ("bool" if op in ("<", ">", "<=", ">=", "==", "!=")
                                       else kind)
        if scalar and op in ("/", "%"):
            fn = ("_idiv" if op == "/" else "_imod") if kind == "int" else (
                "_cdiv" if op == "/" else "_cmod")
            return f"{fn}({a}, {b})", kind if op == "/" or kind == "int" else None
        return f"_B({op!r}, {a}, {b})", None

    def _binary(self, node):
        op = node.op
        if op in ("+=", "-=", "*=", "/=", "%="):
            if not isinstance(node.a, A.Id):
                raise _Bail("compound assignment to a member or element")
            nm = node.a.name
            b, kb = self.expr(node.b)
            new = self._arith(op[0], f"v_{nm}", self.kinds.get(nm), b, kb)
            self._assign(nm, new[1])
            return f"(v_{nm} := {new[0]})", new[1]
        a, ka = self.expr(node.a)
        b, kb = self.expr(node.b)
        if op == "&&":
            return f"(bool({a}) and bool({b}))", "bool"
        if op == "||":
            return f"(bool({a}) or bool({b}))", "bool"
        return self._arith(op, a, ka, b, kb)

    def _call(self, node):
        from pine_tpu_torch.prl.interp import PrlFunction

        args = ", ".join(self.expr(a)[0] for a in node.args)
        cell = self.env.find(node.name)
        if cell is not None:
            v = cell.get()
            if not isinstance(v, PrlFunction):
                raise _Bail(f"call target `{node.name}` is not a pure fn")
            return f"{self._obj(v, 'f')}({args})", None
        fn = self.interp.builtins.get(node.name)
        if fn is None:
            raise _Bail(f"function `{node.name}` is not defined")
        return f"{self._obj(fn, 'b')}({args})", None


def _idiv(a, b):
    """ops._c_div of two concrete integers, without its type tests."""
    q = abs(a) // abs(b)
    return int(q if (a >= 0) == (b >= 0) else -q)


def _imod(a, b):
    """ops._c_mod of two concrete integers, without its type tests."""
    return int(a - _idiv(a, b) * b)


def _has_continue(node):
    if isinstance(node, A.ContinueStmt):
        return True
    if isinstance(node, (A.While, A.For)):
        return False  # a nested loop's own continue
    return any(_has_continue(c) for c in _children(node))


# ---------------------------------------------------------------------------
# entry points (hooked from interp.exec_elem)
# ---------------------------------------------------------------------------

def _mark_nocompile(node):
    """Remember a structural (value-independent) bail so repeated executions
    of the same For statement skip the AST scans (the While tier's flag)."""
    entry = _CACHE.setdefault(id(node), {"node": node})
    if entry.get("node") is node:
        entry["nocompile"] = True


def maybe_run_compiled_for(interp, node, env):
    """Try to compile-and-run an A.For.  True = done; False = run eagerly."""
    if _ACTIVE[0] or _disabled():
        return False
    entry = _CACHE.get(id(node))
    if entry is not None and entry.get("node") is node and entry.get("nocompile"):
        return False
    info = _affine(node)
    if info is None:
        _mark_nocompile(node)
        return False
    loopvar, begin_e, end_e, step_e, strict = info
    from pine_tpu_torch.prl.interp import PRLRuntimeError

    structural = True  # _Bail before any value-dependent check => cacheable
    try:
        seen = set()
        bound_nodes = [begin_e, end_e] + ([step_e] if step_e is not None else [])
        for e in bound_nodes:
            _scan_pure(interp, env, e, seen)
        mut = assigned_names(node.body) | {loopvar}
        refs = set()
        for e in bound_nodes:
            _referenced(e, refs)
        if refs & mut:
            raise _Bail("loop bound depends on loop state")
        structural = False
        begin = _concrete_int(interp.eval(begin_e, env))
        end = _concrete_int(interp.eval(end_e, env))
        step = 1 if step_e is None else _concrete_int(interp.eval(step_e, env))
        if begin is None or end is None or step is None or step <= 0:
            raise _Bail("bounds are not concrete positive-step ints")
        trip = _trip_count(begin, end, step, strict)
        if trip < MIN_TRIP:
            return False
        structural = True
        _scan_pure(interp, env, node.body, seen)
        structural = False
        reds, carries = _classify(env, node.body, loopvar)
        exclude = mut | {nm for nm, _ in reds} | {nm for nm, _ in carries}
        _ACTIVE[0] = True
        try:
            if not carries:
                reads, fn_ids = _collect_reads(interp, env, [node.body], exclude)
                _run_batched(interp, node, env, loopvar, begin, end, step,
                             strict, trip, reds, reads, fn_ids)
            else:
                # the cond and inc also reference outer values -> args too
                reads, fn_ids = _collect_reads(
                    interp, env, [node.body, node.cond, node.inc], exclude
                )
                shadow = sorted(set(reds + carries))
                _run_sequential(interp, node, env, node.cond, node.body,
                                node.inc, shadow, reads, fn_ids,
                                loop_init=(loopvar, begin))
        finally:
            _ACTIVE[0] = False
        return True
    except _Bail as b:
        if structural:
            _mark_nocompile(node)
        _debug(f"for@{node.sl}: {b}")
        return False
    except PRLRuntimeError as e:  # a pure body left the environment as it was: run it eagerly
        _debug(f"for@{node.sl}: {type(e).__name__}: {e}")
        return False


def maybe_run_compiled_while(interp, node, env):
    """Continue a long-running eager While in the sequential tier from its
    current state.  True = the loop ran to completion here; False = keep
    going eagerly."""
    if _ACTIVE[0] or _disabled():
        return False
    entry = _CACHE.get(id(node))
    if entry is not None and entry.get("node") is node and entry.get("nocompile"):
        return False
    from pine_tpu_torch.prl.interp import PRLRuntimeError

    try:
        seen = set()
        _scan_pure(interp, env, node.cond, seen)
        _scan_pure(interp, env, node.body, seen)
        names = assigned_names(node.body) | assigned_names(node.cond)
        shadow = []
        for nm in sorted(names):
            cell = env.find(nm)
            if cell is None:
                continue
            kind = _leaf_kind(cell.get())
            if kind is None:
                raise _Bail(f"`{nm}` mutated but not a compilable value")
            shadow.append((nm, kind))
        reads, fn_ids = _collect_reads(
            interp, env, [node.cond, node.body], set(n for n, _ in shadow)
        )
        _ACTIVE[0] = True
        try:
            _run_sequential(interp, node, env, node.cond, node.body, None,
                            shadow, reads, fn_ids, loop_init=None)
        finally:
            _ACTIVE[0] = False
        return True
    except _Bail as b:
        _debug(f"while@{node.sl}: {b}")
        _entry_for(node, env)["nocompile"] = True
        return False
    except PRLRuntimeError as e:
        _debug(f"while@{node.sl}: {type(e).__name__}: {e}")
        _entry_for(node, env)["nocompile"] = True
        return False
