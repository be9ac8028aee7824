"""PRL tokenizer + recursive-descent parser.

Implements the grammar of the reference's hand-written parser
(jit.cpp:1467-2210) — blocks, while, three `for` forms (C-style; `i in a..b`
exclusive; `i in a~s~b` inclusive), if/else-if/else, `fn`, `class` with
ctor/members/methods, statements with `=` (assign-or-declare), `:=` (declare),
`&=` (ref-bind), lambdas `(x: T): R {...}`, `[a,b,c]` vector literals, both
quote styles, `#` comments.

Operator resolution replicates jit.cpp:1749-1820 exactly: operators collect
into a flat list and reduce by maximum precedence value (leftmost on ties),
preserving the reference's quirks (e.g. `a*b/c` groups as `a*(b/c)` because
Div's code exceeds Mul's; `||` binds tighter than `&&`).

A copy of pine_tpu/prl/parser.py, which is pure Python: the port imports
nothing of pine_tpu.
"""
from __future__ import annotations

from pine_tpu_torch.prl import ast as A


class PRLSyntaxError(Exception):
    def __init__(self, msg, source="", pos=0, filename="<script>"):
        line = source.count("\n", 0, pos) + 1
        col = pos - (source.rfind("\n", 0, pos) + 1) + 1
        lines = source.split("\n")
        vicinity = lines[line - 1] if 0 < line <= len(lines) else ""
        caret = " " * (col - 1) + "^"
        super().__init__(f"{filename}:{line}:{col}: {msg}\n  {vicinity}\n  {caret}")
        self.line, self.col = line, col


# Multi-char operators, longest first (jit.cpp:1775-1795 + stmt ops)
OPS = [
    "++", "--", "+=", "-=", "*=", "/=", "%=", "||", "&&", "!=", "==",
    ">=", "<=", ":=", "&=", "..",
    ">", "<", "-", "+", "^", "%", "/", "*", "=", "!", "~", "(", ")",
    "[", "]", "{", "}", ",", ";", ":", ".", "&",
]

# Precedence codes ordered to reproduce jit.cpp:657-681 (larger binds first,
# leftmost wins ties).
PREC = {
    "*": 700, "/": 701, "%": 702, "^": 703,
    "+": 600, "-": 601,
    "<": 500, ">": 501, "<=": 502, ">=": 503, "==": 504, "!=": 505,
    "&&": 400, "||": 401,
    "+=": 300, "-=": 301, "*=": 302, "/=": 303, "%=": 304,
}

BINARY_OPS = set(PREC)


class Tok:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind  # 'id','int','float','str','op','eof'
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Tok({self.kind},{self.value!r})"


def tokenize(src, filename="<script>"):
    toks = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(Tok("id", src[i:j], i))
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n:
                if src[j].isdigit():
                    j += 1
                elif src[j] == "." and not seen_dot:
                    if j + 1 < n and src[j + 1] == ".":
                        break  # range operator `..`
                    seen_dot = True
                    j += 1
                else:
                    break
            text = src[i:j]
            if seen_dot:
                toks.append(Tok("float", float(text), i))
            else:
                toks.append(Tok("int", int(text), i))
            i = j
            continue
        if c in "\"'":
            q = c
            j = i + 1
            out = []
            while j < n and src[j] != q:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    out.append({"n": "\n", "t": "\t", "\\": "\\", q: q}.get(esc, esc))
                    j += 2
                else:
                    out.append(src[j])
                    j += 1
            if j >= n:
                raise PRLSyntaxError("Unterminated string literal", src, i, filename)
            toks.append(Tok("str", "".join(out), i))
            i = j + 1
            continue
        for op in OPS:
            if src.startswith(op, i):
                toks.append(Tok("op", op, i))
                i += len(op)
                break
        else:
            raise PRLSyntaxError(f"Unexpected character {c!r}", src, i, filename)
    toks.append(Tok("eof", None, n))
    return toks


class Parser:
    def __init__(self, src, filename="<script>"):
        self.src = src
        self.filename = filename
        self.toks = tokenize(src, filename)
        self.i = 0

    # ---- token helpers ----
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def at_op(self, op, k=0):
        t = self.peek(k)
        return t.kind == "op" and t.value == op

    def at_kw(self, kw, k=0):
        t = self.peek(k)
        return t.kind == "id" and t.value == kw

    def accept_op(self, op):
        if self.at_op(op):
            self.i += 1
            return True
        return False

    def accept_kw(self, kw):
        if self.at_kw(kw):
            self.i += 1
            return True
        return False

    def consume_op(self, op, why=""):
        if not self.accept_op(op):
            self.error(f"Expect `{op}` {why}")

    def error(self, msg):
        raise PRLSyntaxError(msg, self.src, self.peek().pos, self.filename)

    # ---- grammar ----
    def parse(self):
        return self.block(top_level=True)

    def block(self, top_level=False):
        if top_level:
            self.accept_op("{")
        else:
            self.consume_op("{", "to begin block")
        elems = []
        while not self.at_op("}") and self.peek().kind != "eof":
            elems.append(self.block_elem())
        if top_level:
            self.accept_op("}")
        else:
            self.consume_op("}", "to end block")
        return A.Block(elems)

    def block_elem(self):
        if self.at_op("{"):
            return self.block()
        if self.at_kw("while"):
            return self.while_()
        if self.at_kw("for"):
            return self.for_()
        if self.at_kw("if"):
            return self.if_else_chain()
        if self.at_kw("fn"):
            return self.fn_def()
        if self.at_kw("class"):
            return self.class_def()
        return self.stmt()

    def while_(self):
        self.accept_kw("while")
        pos = self.peek().pos
        cond = self.expr()
        body = self.block()
        return A.While(cond, body, pos)

    def for_(self):
        self.accept_kw("for")
        pos = self.peek().pos
        # `for id in ...` form?
        if self.peek().kind == "id" and self.at_kw("in", 1):
            name = self.peek().value
            self.i += 2  # id, in
            begin = self.expr()
            if self.accept_op(".."):
                end = self.expr()
                init = A.Decl(name, begin, "declare", pos)
                cond = A.Binary("<", PREC["<"], A.Id(name, pos), end, pos)
                inc = A.Unary("preinc", A.Id(name, pos), pos)
                return A.For(init, cond, inc, self.block(), pos)
            self.consume_op("~", "or .. to specify range")
            step = self.expr()
            self.consume_op("~", "to specify range end")
            end = self.expr()
            init = A.Decl(name, begin, "declare", pos)
            cond = A.Binary("<=", PREC["<="], A.Id(name, pos), end, pos)
            inc = A.Binary("+=", PREC["+="], A.Id(name, pos), step, pos)
            return A.For(init, cond, inc, self.block(), pos)
        # C-style
        init = self.stmt()
        cond = self.expr()
        self.consume_op(";")
        inc = self.expr()
        return A.For(init, cond, inc, self.block(), pos)

    def if_else_chain(self):
        chain = A.IfChain(sl=self.peek().pos)
        self.accept_kw("if")
        chain.conds.append(self.expr())
        chain.blocks.append(self.block())
        while self.at_kw("else"):
            if self.at_kw("if", 1):
                self.i += 2
                chain.conds.append(self.expr())
                chain.blocks.append(self.block())
            else:
                self.i += 1
                chain.else_block = self.block()
                break
        return chain

    def fn_def(self):
        pos = self.peek().pos
        self.accept_kw("fn")
        name = self.id_()
        self.consume_op("(", "to begin parameter definition")
        params = self.param_list()
        self.consume_op(")", "to end parameter definition")
        self.consume_op(":", "to specify return type")
        rtype = self.type_name()
        body = self.block()
        return A.FnDef(name, params, rtype, body, pos)

    def class_def(self):
        pos = self.peek().pos
        self.accept_kw("class")
        name = self.id_()
        self.consume_op("{", "to begin class definition")
        ctors, methods, members = [], [], []
        while not self.accept_op("}"):
            if self.at_kw("ctor"):
                ctors.append(self.ctor_def(name))
            elif self.at_kw("fn"):
                m = self.fn_def()
                methods.append(m)
            else:
                mpos = self.peek().pos
                mname = self.id_()
                self.consume_op(":", "to specify its type")
                mtype = self.id_()
                members.append(A.MemberDef(mname, mtype, mpos))
                self.consume_op(";", "to end the previous member definition")
            while self.accept_op(";"):
                pass
        return A.ClassDef(name, ctors, methods, members, pos)

    def ctor_def(self, class_name):
        pos = self.peek().pos
        self.accept_kw("ctor")
        name = self.id_()
        self.consume_op("(", "to begin parameter definition")
        params = self.param_list()
        self.consume_op(")", "to end parameter definition")
        inits = []
        if self.accept_op(":"):
            while not self.at_op("{"):
                mname = self.id_()
                inits.append((mname, self.expr()))
                if not self.accept_op(","):
                    if not self.at_op("{"):
                        self.error("Expect `,` to continue or `{` to begin ctor body")
        body = self.block()
        return A.CtorDef(name, params, inits, body, pos)

    def param_list(self):
        params = []
        if not self.at_op(")"):
            while True:
                name = self.id_()
                self.consume_op(":", "to specify its type")
                ty = self.type_name()
                params.append((name, ty))
                if self.at_op(")"):
                    break
                self.consume_op(",", "to continue specifying parameters")
        return params

    def type_name(self):
        if self.accept_op("("):
            parts = []
            while not self.at_op(")"):
                parts.append(self.type_name())
                self.accept_op(",")
            self.consume_op(")")
            self.consume_op(":")
            rt = self.type_name()
            return "(" + ", ".join(parts) + "): " + rt
        name = self.id_()
        if self.accept_op("&"):
            name += "&"
        return name

    def id_(self):
        t = self.peek()
        if t.kind != "id":
            self.error("Expect an identifier")
        self.i += 1
        return t.value

    def stmt(self):
        pos = self.peek().pos
        if self.accept_op(";"):
            return A.ExprStmt(A.BoolLit(False, pos), pos)  # empty statement
        if self.at_kw("break"):
            self.i += 1
            s = A.BreakStmt(pos)
        elif self.at_kw("continue"):
            self.i += 1
            s = A.ContinueStmt(pos)
        elif self.at_kw("return"):
            self.i += 1
            s = A.ReturnStmt(None if self.at_op(";") else self.expr(), pos)
        elif self.peek().kind == "id" and self.peek(1).kind == "op" and self.peek(1).value in (
            "=",
            ":=",
            "&=",
        ):
            name = self.peek().value
            op = self.peek(1).value
            self.i += 2
            kind = {"=": "assign_if_exist", ":=": "declare", "&=": "ref"}[op]
            s = A.Decl(name, self.expr(), kind, pos)
        else:
            s = A.ExprStmt(self.expr(), pos)
        self.consume_op(";", "to end statement")
        return s

    # ---- expressions (flat precedence resolution, jit.cpp:1749-1820) ----
    def expr(self):
        exprs, ops, positions = [], [], []
        exprs.append(self._operand())
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in BINARY_OPS:
                self.i += 1
                ops.append(t.value)
                positions.append(t.pos)
                exprs.append(self._operand())
            else:
                break
        while ops:
            # max precedence, leftmost on tie (replicates reference)
            best, idx = -1, 0
            for k, op in enumerate(ops):
                if PREC[op] > best:
                    best, idx = PREC[op], k
            a, b = exprs[idx], exprs[idx + 1]
            node = A.Binary(ops[idx], best, a, b, positions[idx])
            exprs[idx : idx + 2] = [node]
            del ops[idx]
            del positions[idx]
        return exprs[0]

    def _operand(self):
        """One primary operand for the flat expr list; detects lambdas."""
        if self.at_op("("):
            # lambda lookahead: `()` or `(id :`
            if self.at_op(")", 1):
                return self.lambda_()
            if self.peek(1).kind == "id" and self.at_op(":", 2):
                return self.lambda_()
            # parenthesized subexpr can be followed by suffixes? the reference
            # treats a leading `( expr )` operand without suffixes, but
            # `(expr).method()` appears via pexpr_base; allow suffixes.
            return self.expr0()
        return self.expr0()

    def lambda_(self):
        pos = self.peek().pos
        self.consume_op("(", "to start parameter definition")
        params = self.param_list()
        self.consume_op(")", "to end parameter definition")
        self.consume_op(":", "to specify return type")
        rtype = self.type_name()
        body = self.block()
        return A.Lambda(params, rtype, body, pos)

    def expr0(self):
        pos = self.peek().pos
        if self.accept_op("++"):
            return A.Unary("preinc", self.pexpr(), pos)
        if self.accept_op("--"):
            return A.Unary("predec", self.pexpr(), pos)
        if self.accept_op("+"):
            return A.Unary("pos", self.pexpr(), pos)
        if self.accept_op("-"):
            return A.Unary("neg", self.pexpr(), pos)
        if self.accept_op("!"):
            return A.Unary("not", self.pexpr(), pos)
        p = self.pexpr()
        if self.accept_op("++"):
            return A.Unary("postinc", p, pos)
        if self.accept_op("--"):
            return A.Unary("postdec", p, pos)
        return p

    def pexpr(self):
        e = self.pexpr_base()
        while True:
            if self.at_op(".."):
                break
            if self.accept_op("["):
                pos = self.peek().pos
                idx = self.expr()
                self.consume_op("]", "to end subscript")
                e = A.Subscript(e, idx, pos)
            elif self.accept_op("."):
                pos = self.peek().pos
                name = self.id_()
                e = A.Member(e, name, pos)
            elif self.at_op("("):
                # call: id(...) or obj.method(...) -> method(obj, ...)
                if isinstance(e, A.Id):
                    self.i += 1
                    args = self.arg_list()
                    self.consume_op(")")
                    e = A.Call(e.name, args, e.sl)
                elif isinstance(e, A.Member):
                    self.i += 1
                    args = self.arg_list()
                    self.consume_op(")")
                    e = A.Call(e.name, [e.base] + args, e.sl)
                else:
                    self.error("An identifier must precede the call operator ()")
            else:
                break
        return e

    def pexpr_base(self):
        t = self.peek()
        pos = t.pos
        if t.kind == "id" and t.value == "true":
            self.i += 1
            return A.BoolLit(True, pos)
        if t.kind == "id" and t.value == "false":
            self.i += 1
            return A.BoolLit(False, pos)
        if t.kind == "str":
            self.i += 1
            return A.StrLit(t.value, pos)
        if t.kind in ("int", "float"):
            self.i += 1
            return A.NumLit(t.value, pos)
        if self.accept_op("["):
            elems = []
            if not self.accept_op("]"):
                while True:
                    elems.append(self.expr())
                    if self.accept_op("]"):
                        break
                    self.consume_op(",", "to specify more elements")
            return A.VecLit(elems, pos)
        if self.accept_op("("):
            e = self.expr()
            self.consume_op(")", "to balance the parenthesis")
            return e
        if t.kind == "id":
            self.i += 1
            return A.Id(t.value, pos)
        self.error("Expect a primary expression")

    def arg_list(self):
        args = []
        if not self.at_op(")"):
            while True:
                args.append(self.expr())
                if self.at_op(")"):
                    break
                self.consume_op(",", "to continue specifying arguments")
        return args


def parse(source, filename="<script>"):
    return Parser(source, filename).parse()
