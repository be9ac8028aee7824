"""Data-dependent control flow over lanes inside PRL lambdas.  Counterpart of
pine_tpu/prl/trace_flow.py.

The reference JIT compiles arbitrary script control flow to native code
(jit.cpp:1303-1445), so SDF distance functions and draw() fragments may
contain `while` loops and `if`s whose conditions depend on runtime values.
Run over lanes (values.py), such a condition is a bool tensor; this module
lowers the statement over the lanes:

- `while` / C-style `for` with a traced condition -> a masked loop whose
  carry is every variable the loop body mutates, plus a per-lane `active`
  mask (lanes exit independently; finished lanes keep computing but their
  updates are masked out — the wavefront convention).  The host asks the
  device whether any lane is still active every EXIT_CHECK iterations (a
  device-to-host sync each time): the iterations in between change nothing
  on a finished lane, so this is exact.  Where the loop reads no lane value
  that it cannot carry (no call of a script function, whose closure may hold
  lanes), each check also drops the finished lanes, so the loop steps only
  the live ones (``COMPACT``), exact for the same reason.
- `if`/`else if`/`else` with traced conditions -> every branch executes on a
  snapshot of the mutated variables and the results merge with `where`
  (chain semantics: the first true condition wins).  Early `return` is
  supported when EVERY branch (including `else`) returns; the merged value
  propagates as the lambda's return.

Restrictions (API.md): `break`/`continue`/`return` inside a traced *loop*
are not supported (fold the exit test into the condition); variables may
not change type or shape across iterations/branches; branch bodies must be
pure math (side effects like `print` run for all branches).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.prl import ast as A
from pine_tpu_torch.prl.values import PrlMat, PrlVec, as_tensor, scalar_of

EXIT_CHECK = 8  # masked-loop iterations between two asks whether a lane is active
COMPACT = True  # drop finished lanes at each check where the loop allows it
SYNCS = [0]  # device-to-host asks made by masked loops (read by chip_smoke.py)


class _Missing:
    pass


MISSING = _Missing()


# ---------------------------------------------------------------------------
# static analysis: which names does a statement subtree mutate?
# ---------------------------------------------------------------------------

def _root_id(node):
    while isinstance(node, (A.Member, A.Subscript)):
        node = node.base
    return node.name if isinstance(node, A.Id) else None


def assigned_names(node, out=None):
    """Names mutated anywhere in `node` (liberal: includes shadowed ones —
    carrying an extra live variable through the loop is harmless)."""
    if out is None:
        out = set()
    k = type(node)
    if k is A.Decl:
        # 'declare' creates an iteration-local; 'assign_if_exist' may mutate
        # an outer cell.  'ref' aliases: mutations through the alias hit the
        # target, so include the target's root id as well.
        if node.kind == "assign_if_exist":
            out.add(node.name)
        elif node.kind == "ref":
            r = _root_id(node.expr)
            if r:
                out.add(r)
        assigned_names(node.expr, out)
    elif k is A.Binary:
        if node.op in ("+=", "-=", "*=", "/=", "%="):
            r = _root_id(node.a)
            if r:
                out.add(r)
        assigned_names(node.a, out)
        assigned_names(node.b, out)
    elif k is A.Unary:
        if node.op in ("preinc", "predec", "postinc", "postdec"):
            r = _root_id(node.e)
            if r:
                out.add(r)
        assigned_names(node.e, out)
    elif k is A.ExprStmt:
        assigned_names(node.expr, out)
    elif k is A.Block:
        for e in node.elems:
            assigned_names(e, out)
    elif k is A.While:
        assigned_names(node.cond, out)
        assigned_names(node.body, out)
    elif k is A.For:
        assigned_names(node.init, out)
        assigned_names(node.cond, out)
        assigned_names(node.inc, out)
        assigned_names(node.body, out)
    elif k is A.IfChain:
        for c in node.conds:
            assigned_names(c, out)
        for b in node.blocks:
            assigned_names(b, out)
        if node.else_block is not None:
            assigned_names(node.else_block, out)
    elif k is A.Call:
        for a in node.args:
            assigned_names(a, out)
    elif k in (A.Member, A.Subscript):
        assigned_names(node.base, out)
        if k is A.Subscript:
            assigned_names(node.index, out)
    elif k is A.VecLit:
        for e in node.elems:
            assigned_names(e, out)
    elif k is A.ReturnStmt and node.expr is not None:
        assigned_names(node.expr, out)
    # Lambda/FnDef/ClassDef bodies have their own scopes: not descended.
    return out


def children(n):
    """The AST nodes directly under `n`."""
    for f in getattr(n, "__dataclass_fields__", ()):
        v = getattr(n, f)
        if isinstance(v, A.Node):
            yield v
        elif isinstance(v, (list, tuple)):
            for e in v:
                if isinstance(e, A.Node):
                    yield e
                elif isinstance(e, tuple):
                    for ee in e:
                        if isinstance(ee, A.Node):
                            yield ee


def _names_in(node, ids, calls):
    """Every Id name and every Call name under `node` (lambda bodies too)."""
    if isinstance(node, A.Id):
        ids.add(node.name)
    elif isinstance(node, A.Call):
        calls.add(node.name)
    for c in children(node):
        _names_in(c, ids, calls)


# ---------------------------------------------------------------------------
# carry packing: env cells <-> a tuple of tensors over the lanes
# ---------------------------------------------------------------------------

def _leafable(v):
    return isinstance(v, (bool, int, float, np.integer, np.floating, np.bool_, np.ndarray,
                          torch.Tensor))


class CarrySpec:
    """Bidirectional mapping between a set of env cells and a leaf tuple of
    tensors with the lanes ``batch`` leading, on ``like``'s device."""

    def __init__(self, names, env, like, err):
        self.err = err
        self.like = like
        self.batch = tuple(like.shape)
        self.entries = []  # (name, cell, kind, is_int)
        for name in sorted(names):
            cell = env.find(name)
            if cell is None:
                continue
            v = cell.get()
            if isinstance(v, PrlVec):
                self.entries.append((name, cell, "vec", v.is_int))
            elif isinstance(v, PrlMat):
                self.entries.append((name, cell, "mat", False))
            elif _leafable(v):
                self.entries.append((name, cell, "num", False))
            # anything else (scene handles, strings, objects) is not carried

    def pack(self):
        leaves = []
        for name, cell, kind, _ in self.entries:
            v = cell.get()
            if kind == "vec":
                if not isinstance(v, PrlVec):
                    self.err(f"variable `{name}` changed type under traced control flow")
                leaves.append(_over(v.data, self.like, self.batch))
            elif kind == "mat":
                if not isinstance(v, PrlMat):
                    self.err(f"variable `{name}` changed type under traced control flow")
                leaves.append(_over(v.data, self.like, self.batch))
            else:
                if not _leafable(v):
                    self.err(f"variable `{name}` changed type under traced control flow")
                leaves.append(_over(v, self.like, self.batch))
        return tuple(leaves)

    def unpack(self, leaves):
        for (name, cell, kind, is_int), leaf in zip(self.entries, leaves):
            if kind == "vec":
                cell.set(PrlVec(leaf, is_int))
            elif kind == "mat":
                cell.set(PrlMat(leaf))
            else:
                cell.set(leaf)

    def check_stable(self, new, old):
        for (name, *_), n, o in zip(self.entries, new, old):
            if n.shape != o.shape or n.dtype != o.dtype:
                o_dt, n_dt = str(o.dtype).replace("torch.", ""), str(n.dtype).replace("torch.", "")
                self.err(
                    f"variable `{name}` changed shape/dtype inside traced control "
                    f"flow ({o_dt}{list(o.shape)} -> {n_dt}{list(n.shape)}); "
                    "keep loop variables type-stable (e.g. initialize with 0.0, "
                    "not 0, when they become floats)"
                )


def _as_mask(v, like=None):
    d = v.data if isinstance(v, (PrlVec, PrlMat)) else v
    if not isinstance(d, torch.Tensor):
        d = as_tensor(scalar_of(d), like)
    return d if d.dtype == torch.bool else d != 0


def _mwhere(mask, new, old):
    mm = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(mm, new, old)


# ---------------------------------------------------------------------------
# lowerings
# ---------------------------------------------------------------------------

def _errors():
    from pine_tpu_torch.prl.interp import PRLRuntimeError

    def err(msg):
        raise PRLRuntimeError(msg)

    return err


class _Compactor:
    """The lane values a masked loop reads without carrying them, narrowed
    with the carry when finished lanes are dropped, and the full-width
    result the dropped lanes are written into."""

    def __init__(self, interp, env, nodes, spec, batch):
        self.ok = COMPACT and len(batch) == 1
        self.reads = []  # (cell, full value)
        self.lane_idx = self.full = None
        if not self.ok:
            return
        ids, calls = set(), set()
        for n in nodes:
            if n is not None:
                _names_in(n, ids, calls)
        from pine_tpu_torch.prl.interp import Cell

        # a called script function may read lanes through its closure
        if any(env.find(c) is not None for c in calls):
            self.ok = False
            return
        carried = {name for name, *_ in spec.entries}
        for name in sorted(ids - carried):
            cell = env.find(name)
            if cell is None:
                continue
            v = cell.get()
            d = v.data if isinstance(v, (PrlVec, PrlMat)) else v
            if isinstance(d, torch.Tensor):
                if d.ndim == 0 or tuple(d.shape[:1]) != batch or type(cell) is not Cell:
                    self.ok = False
                    return
                self.reads.append((cell, v))

    def narrow(self, carry, active):
        """Drop the finished lanes -> (carry, active) over the live ones."""
        keep = torch.nonzero(active)[:, 0]
        if self.lane_idx is None:
            self.full = carry
            self.lane_idx = keep
        else:
            self.full = tuple(f.index_copy(0, self.lane_idx, c) for f, c in zip(self.full, carry))
            self.lane_idx = self.lane_idx[keep]
        for cell, v in self.reads:
            cell.set(_take(v, self.lane_idx))
        return tuple(c[keep] for c in carry), active[keep]

    def widen(self, carry):
        """The carry over every lane again; the reads restored."""
        if self.lane_idx is None:
            return carry
        for cell, v in self.reads:
            cell.set(v)
        return tuple(f.index_copy(0, self.lane_idx, c) for f, c in zip(self.full, carry))


def _take(v, idx):
    if isinstance(v, PrlVec):
        return PrlVec(v.data[idx], v.is_int)
    if isinstance(v, PrlMat):
        return PrlMat(v.data[idx])
    return v[idx]


def trace_while(interp, first_cond, cond_node, body_block, inc_node, env):
    """Lower a traced `while`/C-`for` to a masked loop over its lanes.
    `first_cond` is the already-evaluated (traced) condition value for the
    current state."""
    from pine_tpu_torch.prl.interp import BreakEx, ContinueEx, ReturnEx

    err = _errors()
    names = assigned_names(body_block)
    if inc_node is not None:
        assigned_names(inc_node, names)
    assigned_names(cond_node, names)  # `while (i++ < n)` style conditions
    active = _as_mask(first_cond)
    spec = CarrySpec(names, env, active, err)
    carry = spec.pack()
    spec.unpack(carry)
    comp = _Compactor(interp, env, (cond_node, body_block, inc_node), spec, tuple(active.shape))
    width = active.numel()
    i = 0
    while True:
        if i % EXIT_CHECK == 0:
            SYNCS[0] += 1
            n_active = int(active.sum())
            if n_active == 0:
                break
            if comp.ok and 2 * n_active <= width:
                carry, active = comp.narrow(carry, active)
                width = n_active
                spec.like = active
                spec.batch = tuple(active.shape)
        spec.unpack(carry)
        try:
            interp.exec_block(body_block, env)
            if inc_node is not None:
                interp.eval(inc_node, env)
        except (BreakEx, ContinueEx):
            err(
                "break/continue inside a data-dependent (traced) loop is not "
                "supported; fold the exit test into the loop condition"
            )
        except ReturnEx:
            err(
                "return inside a data-dependent (traced) loop is not supported; "
                "assign to a variable and return after the loop"
            )
        new = spec.pack()
        spec.check_stable(new, carry)
        carry = tuple(_mwhere(active, n, o) for n, o in zip(new, carry))
        spec.unpack(carry)
        c = _as_mask(interp.eval(cond_node, env), active)
        active = active & c.expand(active.shape)
        i += 1
    spec.unpack(comp.widen(carry))


def trace_ifchain(interp, conds, blocks, else_block, env):
    """Lower a traced if/else-if/else chain: run each branch on a snapshot,
    merge mutated variables (and early returns) with `where`.

    `conds` are the already-evaluated condition VALUES (first one traced;
    later ones may be concrete — they broadcast)."""
    from pine_tpu_torch.prl.interp import BreakEx, ContinueEx, ReturnEx

    err = _errors()
    like = conds[0].data if isinstance(conds[0], (PrlVec, PrlMat)) else conds[0]
    masks = [_as_mask(c, like) for c in conds]
    batch = torch.broadcast_shapes(*[m.shape for m in masks])
    masks = [m.expand(batch) for m in masks]

    names = set()
    for b in blocks:
        assigned_names(b, names)
    if else_block is not None:
        assigned_names(else_block, names)
    spec = CarrySpec(names, env, masks[0], err)
    snapshot = spec.pack()

    outs, rets = [], []
    branch_bodies = list(blocks) + ([else_block] if else_block is not None else [])
    for blk in branch_bodies:
        spec.unpack(snapshot)
        ret = MISSING
        try:
            interp.exec_block(blk, env)
        except (BreakEx, ContinueEx):
            err(
                "break/continue through a data-dependent (traced) if is not "
                "supported"
            )
        except ReturnEx as r:
            ret = r.value
        outs.append(spec.pack())
        rets.append(ret)

    n_ret = sum(1 for r in rets if r is not MISSING)
    if n_ret:
        if n_ret != len(rets) or else_block is None:
            err(
                "under a traced if, either every branch (including else) must "
                "return, or none may; mixed early returns are not supported"
            )
        # merge return values, last (else) branch as the base
        merged = _promote_ret(rets[-1], masks[0])
        for m, r in zip(reversed(masks), reversed([_promote_ret(r, masks[0])
                                                   for r in rets[:-1]])):
            merged = _merge_vals(m, r, merged, err)
        spec.unpack(snapshot)
        raise ReturnEx(merged)

    base = outs[-1] if else_block is not None else snapshot
    branch_outs = outs[: len(masks)]
    merged = base
    for m, o in zip(reversed(masks), reversed(branch_outs)):
        spec.check_stable(o, merged)
        merged = tuple(_mwhere(m, n, old) for n, old in zip(o, merged))
    spec.unpack(merged)


def _over(x, like, batch):
    """``x`` as a tensor with the lanes ``batch`` leading, on ``like``'s
    device: a concrete value (no lanes) broadcast to them."""
    lanes = isinstance(x, torch.Tensor) and x.ndim > 0 and tuple(x.shape[:len(batch)]) == batch
    x = as_tensor(scalar_of(x), like)
    return x if lanes or not batch else x.expand(batch + tuple(x.shape))


def _promote_ret(v, mask):
    batch = tuple(mask.shape)
    if isinstance(v, PrlVec):
        return PrlVec(_over(v.data, mask, batch), v.is_int)
    if isinstance(v, PrlMat) or v is None:
        return v
    return _over(v, mask, batch)


def _merge_vals(mask, a, b, err):
    if (a is None) != (b is None):
        err("branches of a traced if return inconsistent values")
    if a is None:
        return None
    if isinstance(a, PrlVec) or isinstance(b, PrlVec):
        if not (isinstance(a, PrlVec) and isinstance(b, PrlVec)):
            err("branches of a traced if return different types")
        return PrlVec(_mwhere(mask, a.data, b.data), a.is_int and b.is_int)
    return _mwhere(mask, a, b)
