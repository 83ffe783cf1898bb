from .ir import Expr, FuncCall, InputRef, Literal, call, col, lit
from .program import ExprProgram

__all__ = ["Expr", "FuncCall", "InputRef", "Literal", "call", "col", "lit",
           "ExprProgram"]
