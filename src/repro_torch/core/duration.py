"""Duration models d(k): FL rounds-to-convergence vs. mean participants.

Port of :mod:`repro.core.duration`. The paper measures rounds-to-convergence
``d`` for participation probabilities ``p ∈ [0.1, 0.7]`` with N = 50 clients
(Table II) and fits a polynomial regression; ``d(k)`` is then read as a
function of the number of participating nodes ``k ~ PoiBin(p)`` via
``k = N p``.

* ``PAPER_TABLE_II`` — the paper's measured (p, d_mean, d_std, E_mean,
  E_std), this package's own copy.
* ``fit_polynomial_duration`` — weighted least-squares polynomial fit
  (float64, the reference's SVD-based solve).
* ``DurationModel`` — d(k) on k = 0..N with a guarded k = 0 plateau.
* ``theoretical_duration`` — the analytic surrogate d(k) ≈ a + b/k.

The degree-9 fit is ill-conditioned, so its coefficients agree with the
reference's only loosely; the tables it yields agree closely.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "PAPER_TABLE_II",
    "PAPER_N_CLIENTS",
    "fit_polynomial_duration",
    "DurationModel",
    "paper_duration_model",
    "theoretical_duration",
]

PAPER_N_CLIENTS = 50

# Table II(b): p, mean rounds, std rounds, mean energy (Wh), std energy (Wh).
PAPER_TABLE_II: np.ndarray = np.array([
    [0.100, 74.50, 11.47, 1072.14, 123.43],
    [0.125, 68.00, 13.09, 1005.97, 140.49],
    [0.130, 56.00, 5.29, 862.84, 60.19],
    [0.150, 62.50, 8.81, 950.26, 100.14],
    [0.160, 57.25, 6.13, 887.80, 61.31],
    [0.175, 51.00, 9.42, 797.18, 145.67],
    [0.200, 51.00, 4.55, 816.96, 37.86],
    [0.225, 45.50, 3.70, 747.44, 54.52],
    [0.250, 51.00, 9.56, 803.96, 132.64],
    [0.300, 46.75, 2.75, 768.25, 41.50],
    [0.350, 43.00, 5.23, 724.40, 73.21],
    [0.400, 43.25, 2.22, 734.25, 33.22],
    [0.410, 44.50, 5.32, 758.88, 62.29],
    [0.420, 42.75, 4.11, 725.76, 59.45],
    [0.430, 42.75, 3.30, 734.69, 35.41],
    [0.440, 43.00, 4.08, 732.95, 49.07],
    [0.450, 43.50, 4.43, 751.96, 61.11],
    [0.460, 42.75, 5.56, 750.14, 89.77],
    [0.470, 39.50, 3.11, 698.25, 33.15],
    [0.480, 39.25, 6.70, 696.30, 71.74],
    [0.490, 40.67, 2.89, 709.99, 33.48],
    [0.500, 40.00, 0.82, 704.10, 11.11],
    [0.510, 41.75, 3.30, 719.96, 43.71],
    [0.520, 42.50, 7.33, 729.13, 81.90],
    [0.530, 40.00, 3.16, 703.01, 37.23],
    [0.540, 41.75, 4.27, 726.11, 44.34],
    [0.550, 39.50, 2.65, 706.41, 35.12],
    [0.560, 40.25, 2.99, 719.03, 48.51],
    [0.570, 40.50, 4.43, 712.93, 46.15],
    [0.580, 46.25, 14.15, 771.83, 152.41],
    [0.590, 39.00, 2.58, 694.74, 27.70],
    [0.600, 39.00, 4.24, 691.24, 51.19],
    [0.610, 37.75, 2.87, 682.34, 30.05],
    [0.620, 39.75, 5.56, 708.59, 58.31],
    [0.630, 37.75, 3.50, 697.93, 70.71],
    [0.640, 39.75, 5.91, 726.61, 102.68],
    [0.650, 39.00, 2.16, 702.75, 23.75],
    [0.660, 40.75, 4.99, 719.79, 48.48],
    [0.670, 40.00, 4.69, 725.12, 75.90],
    [0.680, 41.25, 4.03, 728.89, 36.60],
    [0.690, 37.50, 3.87, 676.75, 45.17],
    [0.700, 38.25, 5.50, 696.29, 59.19],
])


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for an int ``y ≥ 0`` by binary powering — the order of
    multiplications ``jax.lax.integer_pow`` uses, so powers agree exactly."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, ``rcond = eps·max(M, N)``."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def fit_polynomial_duration(
    mean_participants,
    rounds,
    degree: int = 3,
    weights=None,
) -> torch.Tensor:
    """Weighted least-squares polynomial fit ``d(k) ~ Σ_j c_j k^j``.

    Mirrors the paper's "polynomial regression model" over Table II(b).
    Returns float64 coefficients ``(degree+1,)`` low-order-first.
    """
    k = torch.as_tensor(mean_participants, dtype=torch.float64)
    d = torch.as_tensor(rounds, dtype=torch.float64)
    vander = torch.stack([_ipow(k, j) for j in range(degree + 1)], dim=1)
    if weights is not None:
        w = torch.sqrt(torch.as_tensor(weights, dtype=torch.float64))
        vander = vander * w[:, None]
        d = d * w
    return _lstsq(vander, d)


def _polyval(coeffs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    powers = torch.stack([_ipow(k, j) for j in range(coeffs.shape[0])],
                         dim=-1)
    return powers @ coeffs


@dataclasses.dataclass(frozen=True)
class DurationModel:
    """Evaluates d(k) for k = 0..N participants per round.

    The polynomial is fit on the paper's measured domain p = k/N ∈
    [lo_frac, hi_frac]. Below ``lo_frac`` the raw polynomial is kept (the
    p→0 cliff) but capped at ``d_zero``; above ``hi_frac`` it is replaced by
    the increasing quadratic continuation
    ``d(edge) + rise · ((x - hi)/(1 - hi))²``.

    Attributes:
        coeffs: float64 polynomial coefficients in x = k/N.
        n_nodes: N.
        d_zero: k→0 penalty horizon (rounds).
        d_floor: minimum achievable rounds.
        lo_frac / hi_frac: fitted data range in x = k/N.
        rise: rounds added by the time x = 1 relative to the hi edge.
    """

    coeffs: torch.Tensor
    n_nodes: int
    d_zero: float
    d_floor: float
    lo_frac: float = 0.1
    hi_frac: float = 0.70
    rise: float = 80.0

    def table(self) -> torch.Tensor:
        """d(k) for k = 0..N, shape (N+1,), float64 on the coefficients'
        device. Entry 0 is the penalty horizon."""
        k = torch.arange(self.n_nodes + 1, dtype=torch.float64,
                         device=self.coeffs.device)
        return self.eval_continuous(k)

    def eval_continuous(self, k) -> torch.Tensor:
        """Evaluate d at (possibly fractional) participant count k >= 0."""
        kf = torch.as_tensor(k, dtype=torch.float64, device=self.coeffs.device)
        x = kf / self.n_nodes
        poly = _polyval(self.coeffs, torch.clamp(x, 0.0, self.hi_frac))
        d_edge = _polyval(self.coeffs, torch.tensor(
            self.hi_frac, dtype=torch.float64, device=self.coeffs.device))
        above = d_edge + self.rise * _ipow(
            (x - self.hi_frac) / (1.0 - self.hi_frac), 2)
        d = torch.where(x > self.hi_frac, above, poly)
        d = torch.clamp(d, self.d_floor, self.d_zero)
        # At k = 0 the task never converges: charge the full horizon.
        return torch.where(kf <= 0.0, torch.full_like(d, self.d_zero), d)


def paper_duration_model(degree: int = 9, horizon: float = 500.0,
                         rise: float = 80.0) -> DurationModel:
    """Duration model calibrated on the paper's Table II(b), N = 50.

    Degree 9, inverse-variance weighted, as in the reference: a local
    minimum near p ≈ 0.28 and the global one near p ≈ 0.62. ``horizon``
    is the k→0 penalty.
    """
    tab = PAPER_TABLE_II
    x = torch.as_tensor(tab[:, 0], dtype=torch.float64)
    d = torch.as_tensor(tab[:, 1], dtype=torch.float64)
    w = 1.0 / _ipow(torch.clamp(
        torch.as_tensor(tab[:, 2], dtype=torch.float64), min=0.5), 2)
    coeffs = fit_polynomial_duration(x, d, degree=degree, weights=w)
    d_floor = float(tab[:, 1].min() * 0.9)
    return DurationModel(coeffs=coeffs, n_nodes=PAPER_N_CLIENTS,
                         d_zero=horizon, d_floor=d_floor,
                         lo_frac=float(tab[:, 0].min()),
                         hi_frac=float(tab[:, 0].max()), rise=rise)


def theoretical_duration(
    n_nodes: int,
    d_inf: float = 35.0,
    slope: float = 4.0,
    horizon: float = 500.0,
) -> DurationModel:
    """Analytic surrogate d(k) = d_inf + slope · N / k, fitted (degree 6)
    into a :class:`DurationModel` so both paths share one code path."""
    k = np.arange(1, n_nodes + 1, dtype=np.float64)
    d = d_inf + slope * n_nodes / k
    coeffs = fit_polynomial_duration(k / n_nodes, np.minimum(d, horizon),
                                     degree=6)
    return DurationModel(coeffs=coeffs, n_nodes=n_nodes, d_zero=horizon,
                         d_floor=float(d.min()))
