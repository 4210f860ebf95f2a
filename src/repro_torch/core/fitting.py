"""Fitting the profiler cost curve — paper Eqs (6)-(7).

    F(x) = a * exp(b*x - c) + d * sigmoid(e*x - f) + g

fitted to the 8 probe costs by minimising mean squared error.  The paper
accepts the fit when the error drops below 5%; we implement the same gate
(relative RMSE against the spread of y) and fall back to the best measured
probe when the gate fails — a mis-fit curve must never pick a cap no probe
supports (robustness requirement from O-RAN's reliability mandate).

scipy is unavailable; the MSE minimisation reuses the same downhill-simplex
engine the paper uses for the final curve minimisation, with multi-start
initialisation to avoid local minima of the 7-coefficient landscape.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.simplex import minimize_scalar_on_interval, nelder_mead

_COEF_NAMES = ("a", "b", "c", "d", "e", "f", "g")


def sigmoid(x: np.ndarray | float) -> np.ndarray | float:
    return 1.0 / (1.0 + np.exp(-np.clip(x, -60.0, 60.0)))


def f_curve(x: np.ndarray | float, coef: Sequence[float]) -> np.ndarray | float:
    """Paper Eq (6)."""
    a, b, c, d, e, f, g = coef
    z = np.clip(np.asarray(b * np.asarray(x) - c, dtype=np.float64), -60.0, 60.0)
    return a * np.exp(z) + d * sigmoid(e * np.asarray(x) - f) + g


@dataclasses.dataclass(frozen=True)
class FitResult:
    coef: tuple[float, ...]          # (a, b, c, d, e, f, g)
    rel_rmse: float                  # fit error, relative (paper's <5% gate)
    accepted: bool                   # rel_rmse < gate
    x: np.ndarray                    # probe caps
    y: np.ndarray                    # probe costs (normalised ED^mP)

    def __call__(self, x: np.ndarray | float) -> np.ndarray | float:
        return f_curve(x, self.coef)

    @property
    def coef_dict(self) -> dict[str, float]:
        return dict(zip(_COEF_NAMES, self.coef))


def _mse(coef: np.ndarray, x: np.ndarray, y: np.ndarray) -> float:
    r = f_curve(x, coef) - y
    return float(np.mean(r * r))


def _initial_guesses(x: np.ndarray, y: np.ndarray) -> list[np.ndarray]:
    """Heuristic multi-start seeds.

    The empirical curve (paper Fig 4/5) falls steeply below ~40% cap
    (exponential term, b < 0: instability/compute-bound blow-up at deep
    caps) and rises gently toward 100% (sigmoid term): seeds cover both
    orientations plus a flat curve (LeNet-like outliers).
    """
    y_span = max(float(y.max() - y.min()), 1e-9)
    y_mid = float(np.median(y))
    x_mid = float(np.median(x))
    seeds = [
        # decaying exponential from the left + rising sigmoid to the right
        np.array([y_span, -8.0, -8.0 * x.min(), y_span, 8.0, 8.0 * x_mid, y_mid]),
        # gentler variant
        np.array([y_span / 2, -4.0, -4.0 * x.min(), y_span / 2, 4.0, 4.0 * x_mid, y_mid]),
        # rising exponential toward the right + falling sigmoid
        np.array([y_span / 4, 4.0, 4.0 * x.max(), -y_span, 6.0, 6.0 * x_mid, y_mid]),
        # nearly flat
        np.array([0.0, 1.0, 1.0, 0.0, 1.0, 1.0, y_mid]),
    ]
    return seeds


def fit_cost_curve(
    caps: Sequence[float],
    costs: Sequence[float],
    *,
    error_gate: float = 0.05,
    max_iter: int = 4000,
    x0: Sequence[float] | None = None,
    multi_start: bool = True,
) -> FitResult:
    """Fit Eq (6) to (cap, ED^mP) probes by MSE (Eq 7).

    ``x0`` warm-starts the simplex from known-good coefficients (e.g. the
    previous fit in the online profiler's incremental refits); with
    ``multi_start=False`` only that start (plus its polish) runs — an order
    of magnitude cheaper, appropriate when the probe data moved slightly.
    """
    x = np.asarray(caps, dtype=np.float64)
    y = np.asarray(costs, dtype=np.float64)
    if x.size != y.size or x.size < 3:
        raise ValueError("need >=3 (cap, cost) probes")

    seeds: list[np.ndarray] = []
    if x0 is not None:
        seeds.append(np.asarray(x0, dtype=np.float64))
    if multi_start or not seeds:
        seeds.extend(_initial_guesses(x, y))

    best: tuple[float, np.ndarray] | None = None
    for seed in seeds:
        res = nelder_mead(lambda c: _mse(c, x, y), seed,
                          initial_step=0.25, max_iter=max_iter,
                          xatol=1e-10, fatol=1e-14)
        if best is None or res.fun < best[0]:
            best = (res.fun, res.x)
        # polish the winner from a perturbed restart
        res2 = nelder_mead(lambda c: _mse(c, x, y), best[1] * 1.05 + 1e-3,
                           initial_step=0.05, max_iter=max_iter,
                           xatol=1e-10, fatol=1e-14)
        if res2.fun < best[0]:
            best = (res2.fun, res2.x)

    mse = best[0]
    # Paper: "if the error drops below 5%, we consider the line a good fit".
    # Interpreted as RMSE relative to the dynamic range of the probes (scale-
    # free; the probes themselves are already normalised ED^mP values).
    scale = max(float(np.max(np.abs(y))), 1e-12)
    rel_rmse = float(np.sqrt(mse)) / scale
    return FitResult(
        coef=tuple(float(v) for v in best[1]),
        rel_rmse=rel_rmse,
        accepted=rel_rmse < error_gate,
        x=x,
        y=y,
    )


def minimize_fit(
    fit: FitResult,
    lo: float = 0.3,
    hi: float = 1.0,
) -> tuple[float, float]:
    """Minimise the fitted F(x) over the legal cap range with the downhill
    simplex (paper Sec III-C).  Falls back to the best *measured* probe when
    the fit failed its acceptance gate."""
    if not fit.accepted:
        i = int(np.argmin(fit.y))
        return float(fit.x[i]), float(fit.y[i])
    return minimize_scalar_on_interval(lambda x: float(f_curve(x, fit.coef)), lo, hi)
