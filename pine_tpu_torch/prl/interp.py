"""PRL eager tree-walk interpreter and its lambda bridges.  Counterpart of
pine_tpu/prl/interp.py.

The reference compiles PRL scripts to native code through LLVM
(jit.cpp:2219-2354); the script *is* the program that builds the scene and
invokes renders.  Here:

- scene-building code evaluates eagerly in Python over numpy values, and
  ``render`` runs the port's renderer on the interpreter's device (the card
  unless it was given the CPU);
- lambdas handed to consumers that run them over lanes (``draw``
  fragments, ``SDF`` distances, texture ``Function`` nodes,
  ``heightmap(size, fn)``) are entered with tensors over those lanes
  (values.py), on the lanes' device, through the same evaluator; a
  condition over lanes hands its ``while``/``for``/``if`` to trace_flow.py
  (masked loops, merged branches);
- hot host loops go to loop_jit.py (iterations as lanes, or the loop
  lowered to a Python function), which falls back to this evaluator
  whenever a loop is not eligible.

Method-call sugar, overloaded free functions, ``:=``/``=``/``&=`` statement
forms, class desugaring (ctor synthesizes `self`, members ref-bind into
scope), and capture semantics mirror jit.cpp's emit rules.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.prl import ast as A
from pine_tpu_torch.prl import loop_jit, ops
from pine_tpu_torch.prl.parser import PRLSyntaxError, parse  # noqa: F401 (re-exported)
from pine_tpu_torch.prl.values import (
    PrlMat,
    PrlVec,
    as_tensor,
    is_traced,
    make_vec,
    scalar_of,
    to_float_vec,
)


class PRLRuntimeError(Exception):
    pass


class BreakEx(Exception):
    pass


class ContinueEx(Exception):
    pass


class ReturnEx(Exception):
    def __init__(self, value):
        self.value = value


class Cell:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value

    def set(self, v):
        self.value = v


class PropertyCell:
    """Reference into an object field / vec component (for `&=` and members)."""

    __slots__ = ("getter", "setter")

    def __init__(self, getter, setter):
        self.getter = getter
        self.setter = setter

    def get(self):
        return self.getter()

    def set(self, v):
        self.setter(v)


class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def find(self, name):
        e = self
        while e is not None:
            c = e.vars.get(name)
            if c is not None:
                return c
            e = e.parent
        return None

    def declare(self, name, value):
        cell = Cell(value)
        self.vars[name] = cell
        return cell

    def declare_cell(self, name, cell):
        self.vars[name] = cell


class PrlFunction:
    """Script `fn` definition; closure over its defining env."""

    def __init__(self, node: A.FnDef, env: Env, interp: "Interpreter"):
        self.node = node
        self.env = env
        self.interp = interp

    def __call__(self, *args):
        env = Env(self.env)
        self.interp.bind_params(env, self.node.params, args)
        try:
            self.interp.exec_block(self.node.body, Env(env))
        except ReturnEx as r:
            return r.value
        return None


class PrlLambda(PrlFunction):
    """Lambda `(x: T): R {...}`; also consumable by the bridges that run it
    over lanes (the tensors they are given fix the device)."""

    def as_vec3_to_f32(self):
        """-> f(p (N,3) tensor) -> (N,) for SDF shapes."""

        def fn(p):
            return _lanes(self(PrlVec(p)), p, ())

        return fn

    def as_fragment(self):
        """-> f(uv (N,2) tensor) -> (N,3) for draw()."""

        def fn(uv):
            return _lanes(self(PrlVec(uv)), uv, (3,))

        return fn

    def as_node_fn(self):
        """-> f(ctx dict of (N,k) tensors) for texture Function nodes
        (NodeEvalCtx members p, n, uv)."""

        def fn(ctx):
            r = self(NodeCtxValue(ctx))
            return r.data if isinstance(r, (PrlVec, PrlMat)) else r

        return fn


def _lanes(r, like, tail):
    """A lambda's result as a float32 tensor (N,) + ``tail`` over the lanes
    of ``like``: a concrete value or a lane scalar broadcast."""
    d = r.data if isinstance(r, PrlVec) else r
    d = as_tensor(scalar_of(d), like, torch.float32)
    n = like.shape[0]
    if tail and d.ndim == 1 and d.shape[0] == n and not isinstance(r, PrlVec):
        d = d[:, None]
    return d.expand((n,) + tail)


class NodeCtxValue:
    """PRL view of NodeEvalCtx {p, n, uv} (node.h:13-19)."""

    def __init__(self, ctx):
        self.ctx = ctx

    def member(self, name):
        return PrlVec(self.ctx[name])


class PrlClass:
    def __init__(self, node: A.ClassDef, env: Env, interp: "Interpreter"):
        self.node = node
        self.env = env
        self.interp = interp
        self.methods = {m.name: m for m in node.methods}

    def __call__(self, *args):
        # pick ctor by arity (reference resolves via overload table)
        for ctor in self.node.ctors:
            if len(ctor.params) == len(args):
                return self._run_ctor(ctor, args)
        if not self.node.ctors and not args:
            return self._default_instance()
        raise PRLRuntimeError(
            f"no constructor of `{self.node.name}` takes {len(args)} arguments"
        )

    def _default_instance(self):
        obj = PrlObject(self)
        for m in self.node.members:
            obj.fields[m.name] = default_value(m.type_name)
        return obj

    def _run_ctor(self, ctor, args):
        itp = self.interp
        env = Env(self.env)
        itp.bind_params(env, ctor.params, args)
        obj = self._default_instance()
        env.declare("self", obj)
        for mname, expr in ctor.inits:
            obj.fields[mname] = itp.eval(expr, env)
        # ref-bind members into ctor scope (jit.cpp:1597-1663 desugaring)
        self._bind_members(env, obj)
        try:
            itp.exec_block(ctor.body, Env(env))
        except ReturnEx:
            pass
        return obj

    def _bind_members(self, env, obj):
        for m in self.node.members:
            name = m.name
            env.declare_cell(
                name,
                PropertyCell(
                    lambda n=name: obj.fields[n],
                    lambda v, n=name: obj.fields.__setitem__(n, v),
                ),
            )

    def call_method(self, name, obj, args):
        itp = self.interp
        mdef = self.methods[name]
        env = Env(self.env)
        env.declare("self", obj)
        itp.bind_params(env, mdef.params, args)
        self._bind_members(env, obj)
        try:
            itp.exec_block(mdef.body, Env(env))
        except ReturnEx as r:
            return r.value
        return None


class PrlObject:
    def __init__(self, cls: PrlClass):
        self.cls = cls
        self.fields = {}

    def member(self, name):
        return self.fields[name]

    def set_member(self, name, v):
        self.fields[name] = v


def default_value(type_name):
    t = type_name.rstrip("&")
    if t == "i32":
        return 0
    if t == "f32":
        return 0.0
    if t == "bool":
        return False
    if t == "str":
        return ""
    if t in ("vec2", "vec3", "vec4"):
        return PrlVec(np.zeros(int(t[-1]), np.float32))
    if t in ("vec2i", "vec3i", "vec4i"):
        return PrlVec(np.zeros(int(t[3]), np.int32), True)
    if t in ("mat2", "mat3", "mat4"):
        return PrlMat(np.eye(int(t[-1]), dtype=np.float32))
    return None


def convert_arg(value, type_name):
    """Implicit conversions at typed call boundaries (Context find_f)."""
    t = type_name.rstrip("&")
    if t == "f32":
        if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
            return float(value)
        return value
    if t == "i32":
        if isinstance(value, float):
            return int(value)
        return value
    if t in ("vec2", "vec3", "vec4"):
        return to_float_vec(value)
    return value


class Interpreter:
    """``device``: where ``render`` runs (default: core/options.device, which
    the CLI's --platform sets; None is the card)."""

    def __init__(self, extra_builtins=None, out=None, device=None):
        from pine_tpu_torch.core import options
        from pine_tpu_torch.prl import builtins as B

        self.device = options.device if device is None else device
        self.globals = Env()
        self.out = out if out is not None else _stdout_write
        self.builtins = B.make_registry(self)
        if extra_builtins:
            self.builtins.update(extra_builtins)
        self.script_env = Env(self.globals)

    # ---- public API ----
    def run(self, source, filename="<script>"):
        self.exec_block(parse(source, filename), self.script_env, new_scope=False)

    def get_var(self, name):
        cell = self.script_env.find(name)
        return None if cell is None else cell.get()

    # ---- helpers ----
    def bind_params(self, env, params, args):
        if len(params) != len(args):
            raise PRLRuntimeError(
                f"expected {len(params)} arguments, got {len(args)}"
            )
        for (name, tname), arg in zip(params, args):
            env.declare(name, convert_arg(arg, tname))

    # ---- statements ----
    def exec_block(self, block: A.Block, env: Env, new_scope=True):
        scope = Env(env) if new_scope else env
        for elem in block.elems:
            self.exec_elem(elem, scope)

    def exec_elem(self, node, env):
        k = type(node)
        if k is A.ExprStmt:
            self.eval(node.expr, env)
        elif k is A.Decl:
            if node.kind == "assign_if_exist":
                cell = env.find(node.name)
                v = self.eval(node.expr, env)
                if cell is None:
                    env.declare(node.name, _copy_val(v))
                else:
                    cell.set(_copy_val(v))
            elif node.kind == "declare":
                env.declare(node.name, _copy_val(self.eval(node.expr, env)))
            else:  # ref
                cell = self.lvalue(node.expr, env)
                env.declare_cell(node.name, cell)
        elif k is A.Block:
            self.exec_block(node, env)
        elif k is A.While:
            # a loop may start concrete and become traced mid-flight (e.g.
            # `t := 0.0; while t < 9 { t += sdf(...) }`): check per iteration
            n_iter = 0
            while True:
                c = self.eval(node.cond, env)
                if is_traced(c):
                    from pine_tpu_torch.prl.trace_flow import trace_while

                    trace_while(self, c, node.cond, node.body, None, env)
                    break
                if not bool(c):
                    break
                n_iter += 1
                if n_iter == loop_jit.WHILE_HOT_ITERS:
                    # hot host loop: hand the continuation to loop_jit
                    if loop_jit.maybe_run_compiled_while(self, node, env):
                        break
                try:
                    self.exec_block(node.body, env)
                except BreakEx:
                    break
                except ContinueEx:
                    continue
        elif k is A.For:
            if loop_jit.maybe_run_compiled_for(self, node, env):
                return
            scope = Env(env)
            self.exec_elem(node.init, scope)
            while True:
                c = self.eval(node.cond, scope)
                if is_traced(c):
                    from pine_tpu_torch.prl.trace_flow import trace_while

                    trace_while(self, c, node.cond, node.body, node.inc, scope)
                    break
                if not bool(c):
                    break
                try:
                    self.exec_block(node.body, scope)
                except BreakEx:
                    break
                except ContinueEx:
                    pass
                self.eval(node.inc, scope)
        elif k is A.IfChain:
            for i, (cond, blk) in enumerate(zip(node.conds, node.blocks)):
                c = self.eval(cond, env)
                if is_traced(c):
                    from pine_tpu_torch.prl.trace_flow import trace_ifchain

                    # earlier conds were concrete-false; lower the rest of the
                    # chain (later conds may still be concrete: they broadcast)
                    vals = [c] + [self.eval(cn, env) for cn in node.conds[i + 1:]]
                    trace_ifchain(self, vals, node.blocks[i:], node.else_block, env)
                    return
                if bool(c):
                    self.exec_block(blk, env)
                    return
            if node.else_block is not None:
                self.exec_block(node.else_block, env)
        elif k is A.FnDef:
            env.declare(node.name, PrlFunction(node, env, self))
        elif k is A.ClassDef:
            env.declare(node.name, PrlClass(node, env, self))
        elif k is A.BreakStmt:
            raise BreakEx()
        elif k is A.ContinueStmt:
            raise ContinueEx()
        elif k is A.ReturnStmt:
            raise ReturnEx(None if node.expr is None else self.eval(node.expr, env))
        else:
            raise PRLRuntimeError(f"unknown statement {node}")

    # ---- expressions ----
    def eval(self, node, env):
        k = type(node)
        if k is A.NumLit:
            return node.value
        if k is A.StrLit:
            return node.value
        if k is A.BoolLit:
            return node.value
        if k is A.Id:
            cell = env.find(node.name)
            if cell is None:
                b = self.builtins.get(node.name)
                if b is not None and getattr(b, "is_constant", False):
                    return b()
                raise PRLRuntimeError(f"`{node.name}` is not defined")
            return cell.get()
        if k is A.VecLit:
            return make_vec([self.eval(e, env) for e in node.elems])
        if k is A.Unary:
            return self.eval_unary(node, env)
        if k is A.Binary:
            return self.eval_binary(node, env)
        if k is A.Member:
            base = self.eval(node.base, env)
            return self.member_get(base, node.name)
        if k is A.Subscript:
            base = self.eval(node.base, env)
            idx = self.eval(node.index, env)
            return self.subscript_get(base, idx)
        if k is A.Call:
            return self.eval_call(node, env)
        if k is A.Lambda:
            return PrlLambda(
                A.FnDef("<lambda>", node.params, node.rtype, node.body, node.sl),
                env,
                self,
            )
        raise PRLRuntimeError(f"unknown expression {node}")

    def eval_unary(self, node, env):
        op = node.op
        if op in ("preinc", "predec", "postinc", "postdec"):
            cell = self.lvalue(node.e, env)
            old = cell.get()
            new = ops.binary("+" if "inc" in op else "-", old, 1)
            cell.set(new)
            return new if op.startswith("pre") else old
        return ops.unary(op, self.eval(node.e, env))

    def eval_binary(self, node, env):
        op = node.op
        if op in ("+=", "-=", "*=", "/=", "%="):
            cell = self.lvalue(node.a, env)
            rhs = self.eval(node.b, env)
            new = ops.binary(op[0], cell.get(), rhs)
            cell.set(new)
            return new
        if op == "&&":
            a = self.eval(node.a, env)
            if not is_traced(a) and not a:
                return False
            return ops.binary("&&", a, self.eval(node.b, env))
        if op == "||":
            a = self.eval(node.a, env)
            if not is_traced(a) and a:
                return True
            return ops.binary("||", a, self.eval(node.b, env))
        return ops.binary(op, self.eval(node.a, env), self.eval(node.b, env))

    def eval_call(self, node, env):
        name = node.name
        # 1) callable variable (lambda/function value)
        cell = env.find(name)
        if cell is not None:
            v = cell.get()
            if isinstance(v, (PrlFunction, PrlClass)):
                return v(*[self.eval(a, env) for a in node.args])
            if callable(v) and not isinstance(v, (PrlVec, PrlMat)):
                return v(*[self.eval(a, env) for a in node.args])
        args = [self.eval(a, env) for a in node.args]
        # 2) method on script object
        if args and isinstance(args[0], PrlObject) and name in args[0].cls.methods:
            return args[0].cls.call_method(name, args[0], args[1:])
        # 3) builtin registry
        fn = self.builtins.get(name)
        if fn is not None:
            return fn(*args)
        raise PRLRuntimeError(f"function `{name}` is not defined")

    # ---- lvalues ----
    def lvalue(self, node, env):
        k = type(node)
        if k is A.Id:
            cell = env.find(node.name)
            if cell is None:
                cell = env.declare(node.name, None)
            return cell
        if k is A.Member:
            base = self.eval(node.base, env)
            return PropertyCell(
                lambda: self.member_get(base, node.name),
                lambda v: self.member_set(base, node.name, v),
            )
        if k is A.Subscript:
            base = self.eval(node.base, env)
            idx = self.eval(node.index, env)
            return PropertyCell(
                lambda: self.subscript_get(base, idx),
                lambda v: self.subscript_set(base, idx, v),
            )
        raise PRLRuntimeError(f"expression is not assignable: {node}")

    # ---- member / subscript dispatch ----
    def member_get(self, base, name):
        if isinstance(base, (PrlVec, PrlMat)):
            return base.member(name)
        if isinstance(base, (PrlObject, NodeCtxValue)):
            return base.member(name)
        if hasattr(base, name):
            return getattr(base, name)
        raise PRLRuntimeError(f"{type(base).__name__} has no member `{name}`")

    def member_set(self, base, name, v):
        if isinstance(base, (PrlVec, PrlMat, PrlObject)):
            base.set_member(name, v)
            return
        setattr(base, name, v)

    def subscript_get(self, base, idx):
        if isinstance(base, (PrlVec, PrlMat)):
            return base.subscript(idx)
        from pine_tpu_torch.prl.builtins import Array2dValue

        if isinstance(base, Array2dValue):
            return base.get(idx)
        raise PRLRuntimeError(f"{type(base).__name__} is not subscriptable")

    def subscript_set(self, base, idx, v):
        if isinstance(base, PrlVec):
            base.set_subscript(idx, v)
            return
        from pine_tpu_torch.prl.builtins import Array2dValue

        if isinstance(base, Array2dValue):
            base.set(idx, v)
            return
        raise PRLRuntimeError(f"{type(base).__name__} does not support element assignment")


def _copy_val(v):
    """Value semantics on declaration/assignment (PRL copies like C++)."""
    if isinstance(v, (PrlVec, PrlMat)):
        return v.copy()
    return v


def _stdout_write(s):
    print(s)


# ---- module-level API ------------------------------------------------------

def interpret(source, filename="<script>", interpreter=None):
    itp = interpreter or Interpreter()
    itp.run(source, filename)
    return itp


def interpret_file(path, interpreter=None):
    with open(path) as f:
        src = f.read()
    return interpret(src, filename=path, interpreter=interpreter)
