"""Downhill-simplex (Nelder-Mead) minimiser.

The paper (Sec III-C) uses "the downhill simplex algorithm" to find the
minimum of the fitted cost curve F(x).  scipy is not available in this
environment, so we carry a small, dependency-free implementation that is
also reused by the curve fitter (`repro_torch.core.fitting`).

Implements the adaptive-parameter variant (Gao & Han 2012), which behaves
better in higher dimensions (the F(x) fit has 7 coefficients).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class SimplexResult:
    x: Array                 # argmin found
    fun: float               # value at x
    n_iter: int
    n_eval: int
    converged: bool

    def __iter__(self):      # convenience unpacking: x, fun = nelder_mead(...)
        yield self.x
        yield self.fun


def nelder_mead(
    f: Callable[[Array], float],
    x0: Sequence[float],
    *,
    initial_step: float | Sequence[float] = 0.1,
    max_iter: int = 2000,
    xatol: float = 1e-8,
    fatol: float = 1e-10,
    bounds: Sequence[tuple[float, float]] | None = None,
) -> SimplexResult:
    """Minimise ``f`` starting from ``x0``.

    ``bounds`` are enforced by clipping candidate points (projection), which
    is adequate for the smooth, low-dimensional objectives used here.
    """
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.size
    if bounds is not None:
        lo = np.array([b[0] for b in bounds], dtype=np.float64)
        hi = np.array([b[1] for b in bounds], dtype=np.float64)
        clip = lambda x: np.clip(x, lo, hi)  # noqa: E731
    else:
        clip = lambda x: x  # noqa: E731

    # Adaptive coefficients (Gao & Han).
    alpha = 1.0
    beta = 1.0 + 2.0 / n
    gamma = 0.75 - 1.0 / (2.0 * n)
    delta = 1.0 - 1.0 / n

    steps = np.broadcast_to(np.asarray(initial_step, dtype=np.float64), (n,))
    simplex = np.empty((n + 1, n), dtype=np.float64)
    simplex[0] = clip(x0)
    for i in range(n):
        v = x0.copy()
        v[i] += steps[i]
        simplex[i + 1] = clip(v)

    n_eval = 0

    def feval(x: Array) -> float:
        nonlocal n_eval
        n_eval += 1
        val = float(f(x))
        if not np.isfinite(val):
            return 1e300
        return val

    fvals = np.array([feval(v) for v in simplex])

    n_iter = 0
    converged = False
    while n_iter < max_iter:
        n_iter += 1
        order = np.argsort(fvals, kind="stable")
        simplex, fvals = simplex[order], fvals[order]

        if (np.max(np.abs(simplex[1:] - simplex[0])) <= xatol
                and np.max(np.abs(fvals[1:] - fvals[0])) <= fatol):
            converged = True
            break

        centroid = simplex[:-1].mean(axis=0)
        worst = simplex[-1]

        xr = clip(centroid + alpha * (centroid - worst))
        fr = feval(xr)
        if fr < fvals[0]:
            xe = clip(centroid + beta * (xr - centroid))
            fe = feval(xe)
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
            else:
                simplex[-1], fvals[-1] = xr, fr
        elif fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
        else:
            if fr < fvals[-1]:  # outside contraction
                xc = clip(centroid + gamma * (xr - centroid))
                fc = feval(xc)
                accept = fc <= fr
            else:               # inside contraction
                xc = clip(centroid - gamma * (centroid - worst))
                fc = feval(xc)
                accept = fc < fvals[-1]
            if accept:
                simplex[-1], fvals[-1] = xc, fc
            else:               # shrink towards best
                for i in range(1, n + 1):
                    simplex[i] = clip(simplex[0] + delta * (simplex[i] - simplex[0]))
                    fvals[i] = feval(simplex[i])

    order = np.argsort(fvals, kind="stable")
    return SimplexResult(
        x=simplex[order[0]].copy(),
        fun=float(fvals[order[0]]),
        n_iter=n_iter,
        n_eval=n_eval,
        converged=converged,
    )


def minimize_scalar_on_interval(
    f: Callable[[float], float],
    lo: float,
    hi: float,
    *,
    coarse_points: int = 71,
) -> tuple[float, float]:
    """Global-ish scalar minimisation: coarse grid scan (the paper's Fig 5
    uses 1% increments) followed by a Nelder-Mead polish from the best
    grid point.  Returns (argmin, min)."""
    xs = np.linspace(lo, hi, coarse_points)
    ys = np.array([float(f(x)) for x in xs])
    i = int(np.argmin(ys))
    res = nelder_mead(lambda v: f(float(v[0])), [xs[i]],
                      initial_step=(hi - lo) / (2 * coarse_points),
                      bounds=[(lo, hi)], max_iter=200)
    if res.fun <= ys[i]:
        return float(res.x[0]), float(res.fun)
    return float(xs[i]), float(ys[i])
