"""PRL abstract syntax tree nodes (grammar: reference jit.cpp:1467-2210).

A copy of pine_tpu/prl/ast.py, which is pure Python: the port imports
nothing of pine_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class Node:
    pass


@dataclass
class NumLit(Node):
    value: Any  # int or float
    sl: int = 0


@dataclass
class StrLit(Node):
    value: str
    sl: int = 0


@dataclass
class BoolLit(Node):
    value: bool
    sl: int = 0


@dataclass
class Id(Node):
    name: str
    sl: int = 0


@dataclass
class VecLit(Node):
    elems: List[Node]
    sl: int = 0


@dataclass
class Unary(Node):
    op: str  # 'neg','pos','not','preinc','predec','postinc','postdec'
    e: Node
    sl: int = 0


@dataclass
class Binary(Node):
    op: str
    prec: int
    a: Node
    b: Node
    sl: int = 0


@dataclass
class Subscript(Node):
    base: Node
    index: Node
    sl: int = 0


@dataclass
class Member(Node):
    base: Node
    name: str
    sl: int = 0


@dataclass
class Call(Node):
    name: str
    args: List[Node]
    sl: int = 0


@dataclass
class Lambda(Node):
    params: List[tuple]  # (name, type_name)
    rtype: str
    body: "Block"
    sl: int = 0


@dataclass
class Decl(Node):
    name: str
    expr: Node
    kind: str  # 'assign_if_exist' | 'declare' | 'ref'
    sl: int = 0


@dataclass
class ExprStmt(Node):
    expr: Node
    sl: int = 0


@dataclass
class BreakStmt(Node):
    sl: int = 0


@dataclass
class ContinueStmt(Node):
    sl: int = 0


@dataclass
class ReturnStmt(Node):
    expr: Optional[Node] = None
    sl: int = 0


@dataclass
class Block(Node):
    elems: List[Node] = field(default_factory=list)
    sl: int = 0


@dataclass
class While(Node):
    cond: Node
    body: Block
    sl: int = 0


@dataclass
class For(Node):
    init: Node  # a statement
    cond: Node
    inc: Node  # an expression
    body: Block
    sl: int = 0


@dataclass
class IfChain(Node):
    conds: List[Node] = field(default_factory=list)
    blocks: List[Block] = field(default_factory=list)
    else_block: Optional[Block] = None
    sl: int = 0


@dataclass
class FnDef(Node):
    name: str
    params: List[tuple]
    rtype: str
    body: Block
    sl: int = 0


@dataclass
class MemberDef(Node):
    name: str
    type_name: str
    sl: int = 0


@dataclass
class CtorDef(Node):
    name: str
    params: List[tuple]
    inits: List[tuple]  # (member_name, expr)
    body: Block
    sl: int = 0


@dataclass
class ClassDef(Node):
    name: str
    ctors: List[CtorDef]
    methods: List[FnDef]
    members: List[MemberDef]
    sl: int = 0
