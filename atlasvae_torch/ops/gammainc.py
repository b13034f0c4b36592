"""Log-space regularized incomplete gamma functions and extreme-tail
normal quantiles, in float32 torch on a tensor's own device.

Counterpart of ``atlasvae/ops/gammainc.py``, the same algorithms in the
same order: BumpHunter's per-window Poisson p-values are carried as
**log p**, so a significance has no ceiling (float64 p underflows near
sigma 37.5).

* ``a <= 400``: the lower series (x < a+1) and the modified-Lentz
  continued fraction (x >= a+1) in log space, ``_N_ITER`` = 128 terms
  (127 loop steps each);
* ``a > 400``: Temme's uniform asymptotic expansion with a float32-stable
  series near lam = x/a = 1 and a log-space erfc for large arguments.

Every branch is computed for every element and one is picked with
``torch.where``, as under jit; the loops are Python loops of tensor
operations, so one call launches about 2,000 kernels on a card.
"""

import math

import torch

_LOG_ZERO = -1e30
_HALF_LOG_2PI = 0.9189385332046727
_F32 = torch.float32


def _f32(*values):
    """Float32 tensors on the device of the first tensor among ``values``
    (the CPU when there is none), as ``jnp.asarray(v, jnp.float32)``."""
    device = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    return [torch.as_tensor(v, dtype=_F32, device=device) for v in values]


# ---------------------------------------------------- stable log-prefactors

def _phi(eps):
    """phi(eps) = eps - log1p(eps), float32-stable via series for small eps."""
    series = torch.zeros_like(eps)
    for k in range(11, -1, -1):  # phi/eps^2 = sum (-1)^k eps^k / (k+2)
        series = series * eps + (-1.0) ** k / (k + 2.0)
    series = series * eps ** 2
    direct = eps - torch.log1p(torch.clamp(eps, min=-0.999999))
    return torch.where(torch.abs(eps) < 0.5, series, direct)


def _log_poisson_prefactor(a, x, shift):
    """a ln x - x - lgamma(a + shift), every intermediate O(1) through
    Stirling + phi(eps) where a + shift > 8."""
    b = a + shift
    eps = (x - b) / b
    stable = (-b * _phi(eps) - shift * (torch.log1p(eps) + torch.log(b))
              + 0.5 * torch.log(b)
              - _HALF_LOG_2PI - 1.0 / (12.0 * b) + 1.0 / (360.0 * b ** 3))
    direct = a * torch.log(x) - x - torch.lgamma(b)
    return torch.where(b > 8.0, stable, direct)


# -------------------------------------------------------- exact small-a

# Series/CF terms: the float32 error floor is reached by 96 (measured for
# the JAX package against a long-double oracle); 128 keeps a margin.
_N_ITER = 128


def _log_lower_series(a, x):
    """log P(a,x) by the lower series, valid/convergent for x < a+1."""
    # P(a,x) = x^a e^-x / Gamma(a+1) * sum_k prod_{j<=k} x/(a+j)
    total, term = torch.ones_like(x), torch.ones_like(x)
    for k in range(1, _N_ITER):
        term = term * x / (a + k)
        total = total + term
    return _log_poisson_prefactor(a, x, 1.0) + torch.log(total)


def _log_upper_cf(a, x):
    """log Q(a,x) by the modified-Lentz continued fraction, x >= a+1."""
    tiny = 1e-30
    b0 = x + 1.0 - a
    c = torch.full_like(x, 1.0 / tiny)
    d = 1.0 / torch.clamp(b0, min=tiny)
    h = d
    for i in range(1, _N_ITER):
        an = -i * (i - a)
        b = x + 2.0 * i + 1.0 - a
        d = b + an * d
        d = torch.where(torch.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = torch.where(torch.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    return _log_poisson_prefactor(a, x, 0.0) + torch.log(h)


# --------------------------------------------------------- log-space erfc

def log_erfc(z):
    """log(erfc(z)) for any real z; asymptotic expansion for large z."""
    z, = _f32(z)
    direct = torch.log(torch.clamp(torch.special.erfc(torch.clamp(z, max=5.0)), min=1e-38))
    zc = torch.clamp(z, min=5.0)
    z2 = zc ** 2
    # erfc(z) = exp(-z^2)/(z sqrt(pi)) (1 - 1/(2z^2) + 3/(4z^4) - 15/(8z^6))
    series = torch.log1p(-0.5 / z2 + 0.75 / z2 ** 2 - 1.875 / z2 ** 3)
    asym = -z2 - 0.5 * math.log(math.pi) - torch.log(zc) + series
    return torch.where(z < 5.0, direct, asym)


# ----------------------------------------------------------- Temme large-a

def _temme_terms(a, x):
    """(z, log|corr|, corr_sign) for Temme's expansion, float32-stable:
    eta^2/2 = lam - 1 - ln lam and c0 = 1/eps - 1/eta by power series near
    lam = 1, where they cancel."""
    eps = (x - a) / a
    u2_series = torch.zeros_like(eps)
    for k in range(11, -1, -1):  # eta^2/eps^2 = sum 2(-1)^k eps^k/(k+2)
        u2_series = u2_series * eps + 2.0 * (-1.0) ** k / (k + 2.0)
    eta2_direct = 2.0 * (eps - torch.log1p(torch.clamp(eps, min=-0.999999)))
    use_series = torch.abs(eps) < 0.5
    safe_eps = torch.where(torch.abs(eps) < 1e-12, 1e-12, eps)
    u2 = torch.where(use_series, u2_series, eta2_direct / safe_eps ** 2)
    u = torch.sqrt(torch.clamp(u2, min=1e-12))
    eta2 = u2 * eps ** 2
    eta = eps * u
    z = eta * torch.sqrt(a / 2.0)  # same sign as eps

    tiny = torch.abs(eps) < 1e-3
    # c0 = (u - 1) / (eps u); Taylor -1/3 + eps/12 near 0
    c0 = torch.where(tiny, -1.0 / 3.0 + eps / 12.0,
                     (u - 1.0) / (safe_eps * torch.clamp(u, min=1e-12)))
    s = c0  # one-term expansion: relative error O(1/a) on the correction
    log_corr = -0.5 * a * eta2 - 0.5 * torch.log(2.0 * math.pi * a) + \
        torch.log(torch.clamp(torch.abs(s), min=1e-38))
    return z, log_corr, torch.sign(s)


def _log_sum_or_difference(log_half_erfc, log_corr):
    """(log(e^A + e^B), log(e^max - e^min)) of the two terms."""
    hi = torch.maximum(log_half_erfc, log_corr)
    lo = torch.minimum(log_half_erfc, log_corr)
    same = torch.logaddexp(log_half_erfc, log_corr)
    mag = hi + torch.log1p(-torch.exp(torch.clamp(lo - hi, max=-1e-7)))
    return same, mag


def _log_q_temme(a, x):
    z, log_corr, s_sign = _temme_terms(a, x)
    # Q = 0.5 erfc(z) + sign * exp(log_corr)
    same, mag = _log_sum_or_difference(math.log(0.5) + log_erfc(z), log_corr)
    return torch.where(s_sign > 0, same, mag)


def _log_p_temme(a, x):
    z, log_corr, s_sign = _temme_terms(a, x)
    # P = 0.5 erfc(-z) - sign * exp(log_corr)
    same, mag = _log_sum_or_difference(math.log(0.5) + log_erfc(-z), log_corr)
    return torch.where(s_sign > 0, mag, same)


def _log1m_exp(log_v):
    """log(1 - e^log_v) for log_v <= -1e-7 (the complement of a tail)."""
    return torch.log1p(-torch.exp(torch.clamp(log_v, max=-1e-7)))


# ---------------------------------------------------------------- public

_A_SWITCH = 400.0


def log_gammainc_lower(a, x):
    """log of the lower regularized incomplete gamma P(a, x): for integer
    a = n, the Poisson tail P(X >= n | lam = x), BumpHunter's excess
    p-value."""
    a, x = _f32(a, x)
    a, x = torch.broadcast_tensors(a, x)
    xs = torch.clamp(x, min=1e-30)
    series = _log_lower_series(a, torch.minimum(xs, a + 1.0))
    # x >= a+1: P = 1 - Q with Q <= ~0.5, safe in linear space
    from_cf = _log1m_exp(_log_upper_cf(a, torch.maximum(xs, a + 1.0)))
    exact = torch.where(xs < a + 1.0, series, from_cf)
    temme = torch.where(xs < a, _log_p_temme(a, xs), _log1m_exp(_log_q_temme(a, xs)))
    out = torch.where(a <= _A_SWITCH, exact, temme)
    out = torch.where(x <= 0.0, _LOG_ZERO, out)
    out = torch.where(a <= 0.0, 0.0, out)  # P(0, x>0) = 1
    return torch.clamp(out, max=0.0)


def log_gammainc_upper(a, x):
    """log of the upper regularized incomplete gamma Q(a, x): Q(n+1, lam)
    is the Poisson tail P(X <= n | lam), BumpHunter's deficit p-value."""
    a, x = _f32(a, x)
    a, x = torch.broadcast_tensors(a, x)
    xs = torch.clamp(x, min=1e-30)
    cf = _log_upper_cf(a, torch.maximum(xs, a + 1.0))
    from_series = _log1m_exp(_log_lower_series(a, torch.minimum(xs, a + 1.0)))
    exact = torch.where(xs >= a + 1.0, cf, from_series)
    temme = torch.where(xs >= a, _log_q_temme(a, xs), _log1m_exp(_log_p_temme(a, xs)))
    out = torch.where(a <= _A_SWITCH, exact, temme)
    out = torch.where(x <= 0.0, 0.0, out)  # Q(a, 0) = 1
    return torch.clamp(out, max=0.0)


def sigma_from_log_pval(log_p):
    """Significance sigma = -Phi^-1(p) from log p, unbounded: the inverse
    normal CDF for log p > -60, else 6 Newton steps on the asymptotic
    normal-tail series.  log p >= 0 (no qualifying window) gives 0."""
    log_p, = _f32(log_p)
    p = torch.exp(torch.clamp(log_p, min=-60.0))
    moderate = -_ndtri(torch.clamp(p, 1e-30, 1.0 - 1e-7))

    # deep tail: solve -s^2/2 - ln s - 0.5 ln 2pi + ln(1 - 1/s^2 + 3/s^4) = log_p
    lp = torch.clamp(log_p, max=-60.0)
    s = torch.sqrt(torch.clamp(-2.0 * lp - torch.log(torch.clamp(-2.0 * lp, min=1.0))
                               - math.log(2.0 * math.pi), min=1.0))
    for _ in range(6):
        s2 = s * s
        f = (-0.5 * s2 - torch.log(s) - _HALF_LOG_2PI
             + torch.log1p(-1.0 / s2 + 3.0 / s2 ** 2) - lp)
        df = -s - 1.0 / s + (2.0 / (s * s2) - 12.0 / (s * s2 * s2)) / \
            torch.clamp(1.0 - 1.0 / s2 + 3.0 / s2 ** 2, min=1e-6)
        s = s - f / df
    sigma = torch.where(log_p > -60.0, moderate, s)
    return torch.where(log_p >= 0.0, 0.0, sigma)


_ACKLAM_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
             1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_ACKLAM_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
             6.680131188771972e+01, -1.328068155288572e+01)
_ACKLAM_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
             -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_ACKLAM_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
             3.754408661907416e+00)


def _ndtr(x):
    """The standard normal CDF, 0.5 erfc(-x / sqrt 2), in float32."""
    return 0.5 * torch.special.erfc(-x / torch.sqrt(torch.tensor(2.0, device=x.device)))


def _ndtri(p, p_lo=1e-30):
    """Acklam's inverse normal CDF + one Halley refinement (float32).

    Shared by the statistics (default deep-tail clip) and the
    QuantileTransformer in data/scalers.py (p_lo=1e-7, sklearn's +-5.2
    sigma saturation), so that a precision fix reaches both."""
    dev = p.device
    a, b, c, d = (torch.tensor(t, device=dev, dtype=_F32)
                  for t in (_ACKLAM_A, _ACKLAM_B, _ACKLAM_C, _ACKLAM_D))
    p = torch.clamp(p, p_lo, 1.0 - 1e-7)
    plow, phigh = 0.02425, 1 - 0.02425

    def tail(q):
        r = torch.sqrt(-2 * torch.log(q))
        return (((((c[0] * r + c[1]) * r + c[2]) * r + c[3]) * r + c[4]) * r + c[5]) / \
               ((((d[0] * r + d[1]) * r + d[2]) * r + d[3]) * r + 1)

    def middle(pm):
        q = pm - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)

    x = torch.where(p < plow, tail(p), torch.where(p > phigh, -tail(1 - p), middle(p)))
    e = _ndtr(x) - p
    u = e * torch.sqrt(torch.tensor(2 * math.pi, device=dev, dtype=_F32)) * \
        torch.exp(torch.clamp(x * x / 2, max=60.0))
    return x - u / (1 + x * u / 2)
