"""Safe cut-expression DSL.

Copy of ``atlasvae/utils/expr.py`` (the port imports nothing of the JAX
package).

The reference passes arbitrary Python strings through ``eval`` to select
events (ref OE-VAE/utils.py:171-173, OE-VAE/vae.py:80-82, e.g.
``'(sample["m"] >= 30)'``).  That is an injection hazard and untestable.
This module parses the same expression *syntax* with ``ast`` and evaluates
it against a dict of numpy arrays, admitting only a whitelist of nodes:

* comparisons (``< <= > >= == !=``), chained comparisons
* boolean composition via ``&``/``|``/``~`` and ``and``/``or``/``not``
* arithmetic ``+ - * / // % **`` on fields and constants
* subscripts of the ``sample`` dict with string-literal keys
* ``abs(...)`` / ``log(...)`` / ``log10(...)`` / ``sqrt(...)``

Every cut string used by the reference evaluates identically here.
"""

import ast

import numpy as np


class CutError(ValueError):
    """Raised for a cut expression outside the DSL whitelist."""


_ALLOWED_FUNCS = {
    "abs": np.abs,
    "log": np.log,
    "log10": np.log10,
    "sqrt": np.sqrt,
    "exp": np.exp,
}

_BIN_OPS = {
    ast.Add: np.add,
    ast.Sub: np.subtract,
    ast.Mult: np.multiply,
    ast.Div: np.divide,
    ast.FloorDiv: np.floor_divide,
    ast.Mod: np.mod,
    ast.Pow: np.power,
    ast.BitAnd: np.logical_and,
    ast.BitOr: np.logical_or,
}

_CMP_OPS = {
    ast.Lt: np.less,
    ast.LtE: np.less_equal,
    ast.Gt: np.greater,
    ast.GtE: np.greater_equal,
    ast.Eq: np.equal,
    ast.NotEq: np.not_equal,
}


def _eval(node, sample):
    if isinstance(node, ast.Expression):
        return _eval(node.body, sample)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float, bool, str)):
            return node.value
        raise CutError(f"constant {node.value!r} not allowed")
    if isinstance(node, ast.Name):
        if node.id == "sample":
            raise CutError("bare 'sample' not allowed; subscript it")
        raise CutError(f"name {node.id!r} not allowed")
    if isinstance(node, ast.Subscript):
        base = node.value
        if not (isinstance(base, ast.Name) and base.id == "sample"):
            raise CutError("only sample[...] subscripts are allowed")
        key = _eval(node.slice, sample)
        if not isinstance(key, str):
            raise CutError("sample keys must be string literals")
        if key not in sample:
            raise CutError(f"unknown sample key {key!r}")
        return np.asarray(sample[key])
    if isinstance(node, ast.Compare):
        result = None
        left = _eval(node.left, sample)
        for op, comparator in zip(node.ops, node.comparators):
            right = _eval(comparator, sample)
            if type(op) not in _CMP_OPS:
                raise CutError(f"comparison {type(op).__name__} not allowed")
            part = _CMP_OPS[type(op)](left, right)
            result = part if result is None else np.logical_and(result, part)
            left = right
        return result
    if isinstance(node, ast.BinOp):
        if type(node.op) not in _BIN_OPS:
            raise CutError(f"operator {type(node.op).__name__} not allowed")
        return _BIN_OPS[type(node.op)](_eval(node.left, sample), _eval(node.right, sample))
    if isinstance(node, ast.BoolOp):
        fn = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
        values = [_eval(v, sample) for v in node.values]
        out = values[0]
        for v in values[1:]:
            out = fn(out, v)
        return out
    if isinstance(node, ast.UnaryOp):
        if isinstance(node.op, ast.USub):
            return np.negative(_eval(node.operand, sample))
        if isinstance(node.op, (ast.Not, ast.Invert)):
            return np.logical_not(_eval(node.operand, sample))
        raise CutError(f"unary {type(node.op).__name__} not allowed")
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name) or node.func.id not in _ALLOWED_FUNCS:
            raise CutError("only abs/log/log10/sqrt/exp calls are allowed")
        if node.keywords:
            raise CutError("keyword arguments not allowed")
        return _ALLOWED_FUNCS[node.func.id](*[_eval(a, sample) for a in node.args])
    raise CutError(f"node {type(node).__name__} not allowed")


def evaluate_cut(expression, sample):
    """Evaluate one cut string against a sample dict -> boolean mask.

    Accepts the reference's cut strings verbatim, e.g.
    ``'(sample["m"] >= 30)'`` (ref OE-VAE/vae.py:80-82).
    """
    try:
        tree = ast.parse(expression, mode="eval")
    except SyntaxError as exc:
        raise CutError(f"cannot parse cut {expression!r}: {exc}") from exc
    mask = _eval(tree, sample)
    return np.asarray(mask, dtype=bool)
