"""Declarative modeling layer: the framework's equivalent of the reference's
JuMP/MathOptInterface front-end (`src/MOI_wrapper.jl`), Python-native. Port
of `loraine_tpu/modeling.py`: the expressions and the lowering are the same
numpy code, kept as the port's own copy; `Model.solve` takes ``device=``.

Build problems from PSD matrix variables, nonnegative/free scalar variables,
and affine constraints; the layer lowers to the solver's primal form

    min  <C, X> + d_lin' x_lin
    s.t. sum_i <A_j^(i), X_i> + (C_lin' row_j) . x_lin = b_j,  X >= 0, x_lin >= 0

introducing slacks for inequalities and sign-splitting free variables.

Example (the max-cut relaxation)::

    m = Model()
    X = m.psd_var(4)
    for i in range(4):
        m.add_constraint(X[i, i] == 1)
    m.maximize(0.25 * dot(L, X))
    res = m.solve({"eDIMACS": 1e-7})            # device="cuda" by default
    res.value(X)        # the Gram matrix
    res.objective       # the relaxation value
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["Model", "PSDVar", "ScalarVar", "LinExpr", "dot", "trace", "ModelResult"]

Atom = Tuple  # ("X", var_id, i, j) or ("s", var_id)


class LinExpr:
    """Affine expression: sum of coefficients over atoms plus a constant."""

    __slots__ = ("terms", "const")

    def __init__(self, terms: Optional[Dict[Atom, float]] = None, const: float = 0.0):
        self.terms = dict(terms or {})
        self.const = float(const)

    @staticmethod
    def wrap(v) -> "LinExpr":
        if isinstance(v, LinExpr):
            return v
        if isinstance(v, ScalarVar):
            return v.expr()
        if np.isscalar(v) or (isinstance(v, np.ndarray) and v.ndim == 0):
            return LinExpr(const=float(v))
        raise TypeError(f"cannot use {type(v)} in a linear expression")

    def _combine(self, other, sign) -> "LinExpr":
        other = LinExpr.wrap(other)
        out = LinExpr(self.terms, self.const + sign * other.const)
        for a, c in other.terms.items():
            out.terms[a] = out.terms.get(a, 0.0) + sign * c
        return out

    def __add__(self, other):
        return self._combine(other, 1.0)

    __radd__ = __add__

    def __sub__(self, other):
        return self._combine(other, -1.0)

    def __rsub__(self, other):
        return LinExpr.wrap(other)._combine(self, -1.0)

    def __neg__(self):
        return self * -1.0

    def __mul__(self, k):
        if not np.isscalar(k):
            raise TypeError("expressions are linear; can only scale by scalars")
        k = float(k)
        return LinExpr({a: c * k for a, c in self.terms.items()}, self.const * k)

    __rmul__ = __mul__

    def __truediv__(self, k):
        return self * (1.0 / float(k))

    # relational operators produce constraints
    def __eq__(self, other):  # type: ignore[override]
        return _Constraint(self - other, "==")

    def __le__(self, other):
        return _Constraint(self - other, "<=")

    def __ge__(self, other):
        return _Constraint(self - other, ">=")

    def __hash__(self):  # keep LinExpr usable as keys despite __eq__
        return id(self)


@dataclasses.dataclass
class _Constraint:
    expr: LinExpr  # relation against 0: expr (==|<=|>=) 0
    kind: str
    name: Optional[str] = None


class PSDVar:
    def __init__(self, model: "Model", var_id: int, m: int, name: str):
        self.model = model
        self.var_id = var_id
        self.m = m
        self.name = name

    def __getitem__(self, ij) -> LinExpr:
        i, j = ij
        if not (0 <= i < self.m and 0 <= j < self.m):
            raise IndexError(f"index {ij} out of range for {self.m}x{self.m} PSD var")
        return LinExpr({("X", self.var_id, min(i, j), max(i, j)): 1.0})


class ScalarVar:
    def __init__(self, model: "Model", var_id: int, name: str, free: bool):
        self.model = model
        self.var_id = var_id
        self.name = name
        self.free = free
        self.minus_id: Optional[int] = None  # set for free vars (sign split)

    def expr(self) -> LinExpr:
        if self.free:
            return LinExpr({("s", self.var_id): 1.0, ("s", self.minus_id): -1.0})
        return LinExpr({("s", self.var_id): 1.0})

    # arithmetic sugar delegates to the expression
    def __add__(self, o):
        return self.expr() + o

    __radd__ = __add__

    def __sub__(self, o):
        return self.expr() - o

    def __rsub__(self, o):
        return LinExpr.wrap(o) - self.expr()

    def __mul__(self, k):
        return self.expr() * k

    __rmul__ = __mul__

    def __neg__(self):
        return -self.expr()

    def __eq__(self, o):  # type: ignore[override]
        return self.expr() == o

    def __le__(self, o):
        return self.expr() <= o

    def __ge__(self, o):
        return self.expr() >= o

    def __hash__(self):
        return id(self)


def dot(M: np.ndarray, X: PSDVar) -> LinExpr:
    """<M, X> for a constant symmetric matrix M."""
    M = np.asarray(M, dtype=float)
    if M.shape != (X.m, X.m):
        raise ValueError(f"shape mismatch: {M.shape} vs {(X.m, X.m)}")
    terms: Dict[Atom, float] = {}
    for i in range(X.m):
        for j in range(i, X.m):
            c = M[i, j] if i == j else M[i, j] + M[j, i]
            if c != 0.0:
                terms[("X", X.var_id, i, j)] = terms.get(("X", X.var_id, i, j), 0.0) + c
    return LinExpr(terms)


def trace(X: PSDVar) -> LinExpr:
    return LinExpr({("X", X.var_id, i, i): 1.0 for i in range(X.m)})


@dataclasses.dataclass
class ModelResult:
    objective: float
    status: int
    status_name: str
    raw: object  # the solver Result
    _psd_values: Dict[int, np.ndarray]
    _scalar_values: Dict[int, float]
    _constraint_duals: np.ndarray

    def value(self, v: Union[PSDVar, ScalarVar, LinExpr]) -> Union[np.ndarray, float]:
        if isinstance(v, PSDVar):
            return self._psd_values[v.var_id]
        if isinstance(v, ScalarVar):
            if v.free:
                return self._scalar_values[v.var_id] - self._scalar_values[v.minus_id]
            return self._scalar_values[v.var_id]
        v = LinExpr.wrap(v)
        tot = v.const
        for a, c in v.terms.items():
            if a[0] == "X":
                _, vid, i, j = a
                tot += c * self._psd_values[vid][i, j]
            else:
                tot += c * self._scalar_values[a[1]]
        return tot

    def dual(self, cons: _Constraint) -> float:
        """The multiplier y_j of the constraint's primal row."""
        return float(self._constraint_duals[cons._row])  # type: ignore[attr-defined]


class Model:
    def __init__(self):
        self._psd: List[PSDVar] = []
        self._scalars: List[ScalarVar] = []
        self._constraints: List[_Constraint] = []
        self._objective: Optional[LinExpr] = None
        self._sense = 1.0  # +1 minimize, -1 maximize

    # -- variables -------------------------------------------------------
    def psd_var(self, m: int, name: Optional[str] = None) -> PSDVar:
        v = PSDVar(self, len(self._psd), m, name or f"X{len(self._psd)}")
        self._psd.append(v)
        return v

    def nonneg_var(self, name: Optional[str] = None) -> ScalarVar:
        v = ScalarVar(self, len(self._scalars), name or f"s{len(self._scalars)}", free=False)
        self._scalars.append(v)
        return v

    def free_var(self, name: Optional[str] = None) -> ScalarVar:
        # sign-split: value = s_plus - s_minus
        vid = len(self._scalars)
        v = ScalarVar(self, vid, name or f"f{vid}", free=True)
        self._scalars.append(v)
        minus = ScalarVar(self, len(self._scalars), v.name + "_minus", free=False)
        self._scalars.append(minus)
        v.minus_id = minus.var_id
        return v

    # -- constraints & objective ----------------------------------------
    def add_constraint(self, cons: _Constraint, name: Optional[str] = None) -> _Constraint:
        if not isinstance(cons, _Constraint):
            raise TypeError("add_constraint expects an expression comparison")
        cons.name = name
        self._constraints.append(cons)
        return cons

    def minimize(self, expr) -> None:
        self._objective = LinExpr.wrap(expr)
        self._sense = 1.0

    def maximize(self, expr) -> None:
        self._objective = LinExpr.wrap(expr)
        self._sense = -1.0

    # -- lowering + solve ------------------------------------------------
    def solve(self, options: Optional[dict] = None,
              device: Union[str, torch.device] = "cuda") -> ModelResult:
        """Lower to the solver's primal form and solve on ``device`` ('cuda'
        by default; raises without a card)."""
        from .problem import problem_from_dense
        from .ipm.solver import solve as _solve

        if self._objective is None:
            self._objective = LinExpr()

        nslack = sum(1 for c in self._constraints if c.kind != "==")
        nlin = len(self._scalars) + nslack
        n = len(self._constraints)
        if n == 0:
            raise ValueError("model has no constraints")

        As = [np.zeros((n, v.m, v.m)) for v in self._psd]
        b = np.zeros(n)
        C_lin = np.zeros((n, nlin)) if nlin else None
        d_lin = np.zeros(nlin) if nlin else None

        def scatter(expr: LinExpr, row: Optional[int], obj: bool = False):
            for a, c in expr.terms.items():
                if a[0] == "X":
                    _, vid, i, j = a
                    tgt = Cs[vid] if obj else As[vid][row]
                    half = c if i == j else c / 2.0
                    tgt[i, j] += half
                    if i != j:
                        tgt[j, i] += half
                else:
                    vid = a[1]
                    if obj:
                        d_lin[vid] += c
                    else:
                        C_lin[row, vid] += c

        Cs = [np.zeros((v.m, v.m)) for v in self._psd]
        obj = self._objective * self._sense  # minimize form
        scatter(obj, None, obj=True)

        slack_pos = len(self._scalars)
        for row, cons in enumerate(self._constraints):
            cons._row = row  # type: ignore[attr-defined]
            scatter(cons.expr, row)
            b[row] = -cons.expr.const
            if cons.kind == "<=":
                C_lin[row, slack_pos] = 1.0
                slack_pos += 1
            elif cons.kind == ">=":
                C_lin[row, slack_pos] = -1.0
                slack_pos += 1

        opts = {"verb": 0, "eDIMACS": 1e-7}
        opts.update(options or {})
        datarank = int(opts.pop("datarank", 0))
        pad_multiple = int(opts.pop("pad_multiple", 8))
        storage = opts.pop("storage", "auto")
        prob = problem_from_dense(
            As, Cs, b, C_lin=C_lin, d_lin=d_lin,
            datarank=datarank, pad_multiple=pad_multiple, storage=storage, device=device,
        )
        res = _solve(prob, opts, device=device)

        psd_values = {v.var_id: res.X[v.var_id] for v in self._psd}
        scalar_values = {
            v.var_id: (float(res.X_lin[v.var_id]) if res.X_lin is not None else 0.0)
            for v in self._scalars
        }
        # Result.objective is -b'y (SDPA sign convention); the lowered
        # problem's primal minimum <C,X> + d'x equals b'y at optimality
        primal_min = -res.objective + obj.const
        return ModelResult(
            objective=self._sense * primal_min,
            status=res.status,
            status_name=res.status_name,
            raw=res,
            _psd_values=psd_values,
            _scalar_values=scalar_values,
            _constraint_duals=res.y,
        )
