"""Feature scalers: numpy fitting, torch transforms.

Counterpart of ``atlasvae/data/scalers.py``: the same ``Scaler`` fields and
pickle format, the same fits (QuantileTransformer with normal output,
Yeo-Johnson PowerTransformer, RobustScaler, MaxAbsScaler), and transforms
that run on a tensor's own device.  ``interp`` reproduces ``jnp.interp``,
ties in ``xp`` included, because quantile tables of discrete features have
runs of equal values.  ``Scaler.load`` reads pickles written by either
package without importing the JAX one.
"""

import dataclasses
import pickle
import time

import numpy as np
import torch

from ..ops.gammainc import _ndtr, _ndtri as _shared_ndtri

_N_QUANTILES = 10_000


class _ScalerUnpickler(pickle.Unpickler):
    """Maps the JAX package's ``atlasvae.data.scalers.Scaler`` to this
    module's class, so loading its pickles does not import JAX."""

    def find_class(self, module, name):
        if name == "Scaler" and module in ("atlasvae.data.scalers", __name__):
            return Scaler
        return super().find_class(module, name)


@dataclasses.dataclass
class Scaler:
    kind: str
    # quantile: per-feature sorted reference values (n_quantiles, n_features)
    quantiles: np.ndarray | None = None
    # robust: medians/iqr; maxabs: scale; power: lambdas + mean/std
    center: np.ndarray | None = None
    scale: np.ndarray | None = None
    lambdas: np.ndarray | None = None

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path):
        """Load a scaler pickle (this package's, the JAX package's, or a
        fitted sklearn transformer, converted)."""
        with open(path, "rb") as f:
            obj = _ScalerUnpickler(f).load()
        if isinstance(obj, Scaler):
            return obj
        return Scaler.from_sklearn(obj)

    @staticmethod
    def from_sklearn(obj):
        """Convert a fitted sklearn transformer of the four supported types."""
        name = type(obj).__name__
        if name == "QuantileTransformer":
            if getattr(obj, "output_distribution", None) != "normal":
                raise ValueError(
                    "only output_distribution='normal' QuantileTransformers "
                    f"are supported, got {obj.output_distribution!r}")
            return Scaler(kind="quantile-normal",
                          quantiles=np.asarray(obj.quantiles_, np.float32))
        if name == "RobustScaler":
            n = (len(obj.scale_) if obj.with_scaling else
                 len(obj.center_) if obj.with_centering else
                 int(obj.n_features_in_))
            scale = (np.asarray(obj.scale_, np.float64)
                     if obj.with_scaling else np.ones(n))
            center = (np.asarray(obj.center_, np.float64)
                      if obj.with_centering else np.zeros_like(scale))
            return Scaler(kind="robust", center=center.astype(np.float32),
                          scale=scale.astype(np.float32))
        if name == "PowerTransformer":
            if getattr(obj, "method", "yeo-johnson") != "yeo-johnson":
                raise ValueError("only method='yeo-johnson' PowerTransformers"
                                 f" are supported, got {obj.method!r}")
            lams = np.asarray(obj.lambdas_, np.float64)
            if obj.standardize:
                center = np.asarray(obj._scaler.mean_, np.float64)
                scale = np.asarray(obj._scaler.scale_, np.float64)
            else:
                center, scale = np.zeros_like(lams), np.ones_like(lams)
            return Scaler(kind="power-yj", lambdas=lams.astype(np.float32),
                          center=center.astype(np.float32),
                          scale=scale.astype(np.float32))
        if name == "MaxAbsScaler":
            return Scaler(kind="maxabs", scale=np.asarray(obj.scale_, np.float32))
        raise TypeError(f"cannot convert {name!r} to a Scaler; supported: "
                        "QuantileTransformer(normal), RobustScaler, "
                        "PowerTransformer(yeo-johnson), MaxAbsScaler")


# ---------------------------------------------------------------- fitting

def _yeo_johnson(x, lam):
    pos = x >= 0
    lam_nz = np.where(np.abs(lam) < 1e-8, 1.0, lam)
    lam2_nz = np.where(np.abs(lam - 2.0) < 1e-8, 1.0, 2.0 - lam)
    yp = np.where(np.abs(lam) < 1e-8, np.log1p(x), ((1 + x) ** lam_nz - 1) / lam_nz)
    yn = np.where(np.abs(lam - 2.0) < 1e-8, -np.log1p(-x),
                  -(((1 - x) ** lam2_nz) - 1) / lam2_nz)
    return np.where(pos, yp, yn)


def _yj_loglik(x, lam):
    n = len(x)
    y = _yeo_johnson(x, lam)
    var = np.var(y)
    if var <= 0 or not np.isfinite(var):
        return -np.inf
    return -0.5 * n * np.log(var) + (lam - 1) * np.sum(np.sign(x) * np.log1p(np.abs(x)))


def _fit_yj_lambda(x, lo=-4.0, hi=4.0, iters=60):
    """Golden-section MLE for the Yeo-Johnson exponent."""
    gr = (np.sqrt(5.0) - 1) / 2
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = _yj_loglik(x, c), _yj_loglik(x, d)
    for _ in range(iters):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = _yj_loglik(x, c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = _yj_loglik(x, d)
    return (a + b) / 2


def fit_scaler(sample, n_dims=3, scaler_out=None, scaler_type="RobustScaler",
               reshape=False, verbose=True):
    """Fit a scaler on the training sample (numpy, float64)."""
    if not scaler_type:
        return None
    start = time.time()
    if verbose:
        print(f"Fitting {scaler_type} to QCD sample", end="", flush=True)
    x = np.asarray(sample, dtype=np.float64)
    if reshape:
        x = x.reshape(-1, n_dims)
    if scaler_type == "QuantileTransformer":
        # sklearn's QuantileTransformer(subsample=1e5) default
        if len(x) > 100_000:
            idx = np.random.default_rng(0).choice(len(x), 100_000, replace=False)
            x_fit = x[idx]
        else:
            x_fit = x
        n_q = min(_N_QUANTILES, len(x_fit))
        refs = np.linspace(0, 1, n_q)
        quantiles = np.nanquantile(x_fit, refs, axis=0)
        scaler = Scaler(kind="quantile-normal", quantiles=quantiles.astype(np.float32))
    elif scaler_type == "PowerTransformer":
        lams = np.array([_fit_yj_lambda(x[:, j]) for j in range(x.shape[1])])
        y = np.stack([_yeo_johnson(x[:, j], lams[j]) for j in range(x.shape[1])], axis=1)
        scaler = Scaler(kind="power-yj", lambdas=lams.astype(np.float32),
                        center=np.mean(y, axis=0).astype(np.float32),
                        scale=np.maximum(np.std(y, axis=0), 1e-12).astype(np.float32))
    elif scaler_type == "RobustScaler":
        q25, q50, q75 = np.percentile(x, [25, 50, 75], axis=0)
        iqr = np.where(q75 - q25 == 0, 1.0, q75 - q25)
        scaler = Scaler(kind="robust", center=q50.astype(np.float32),
                        scale=iqr.astype(np.float32))
    elif scaler_type == "MaxAbsScaler":
        scale = np.max(np.abs(x), axis=0)
        scale = np.where(scale == 0, 1.0, scale)
        scaler = Scaler(kind="maxabs", scale=scale.astype(np.float32))
    else:
        raise ValueError(f"unknown scaler type {scaler_type!r}")
    if verbose:
        print(f" ({time.time() - start:2.1f} s)")
    if scaler_out:
        if verbose:
            print("Saving to " + str(scaler_out))
        scaler.save(scaler_out)
    return scaler


# ------------------------------------------------------------- transforms

def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` along the last dim, batched over leading
    dims (x (..., N), xp and fp (..., Q)).  Same rules as JAX: the right
    neighbour is ``searchsorted(side='right')`` clipped to [1, Q-1], a
    zero-width interval (tied xp) takes the left value, and points outside
    [xp[0], xp[-1]] take the end values."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[-1] - 1)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    epsilon = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= epsilon
    # fused multiply-add, as XLA contracts fp0 + (delta / dx) * df
    f = torch.where(dx0, fp0,
                    torch.addcmul(fp0, delta / torch.where(dx0, torch.ones_like(dx), dx), df))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _linspace01(n, device):
    """``jnp.linspace(0, 1, n)`` in float32, bit for bit: iota / (n-1),
    which XLA computes as iota * f32(1 / (n-1))."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * \
        float(np.float32(1) / np.float32(n - 1))
    return torch.cat([step, torch.ones(1, device=device)])


def _ndtri(p):
    """Inverse standard-normal CDF, clipped to [1e-7, 1-1e-7] (sklearn's
    QuantileTransformer saturates at the same +-5.2 sigma).  Delegates to
    the one Acklam+Halley implementation in ops/gammainc.py."""
    return _shared_ndtri(p, p_lo=1e-7)


def _quantile_transform(x, quantiles):
    refs = _linspace01(quantiles.shape[0], x.device)
    col, qcol = x.T.contiguous(), quantiles.T.contiguous()      # (F, N), (F, Q)
    refs = refs.expand_as(qcol)
    # two-sided interpolation, as sklearn does, for exact-tie symmetry
    fwd = interp(col, qcol, refs)
    rev = -interp(-col, -qcol.flip(-1), -refs.flip(-1))
    return _ndtri((0.5 * (fwd + rev)).T)


def _quantile_inverse(z, quantiles):
    refs = _linspace01(quantiles.shape[0], z.device)
    qcol = quantiles.T.contiguous()
    p = _ndtr(z).T.contiguous()
    return interp(p, refs.expand_as(qcol).contiguous(), qcol).T


def _yj_transform(x, lam, center, scale):
    lam = lam[None, :]
    pos = x >= 0
    lam_nz = torch.where(torch.abs(lam) < 1e-8, torch.ones_like(lam), lam)
    lam2_nz = torch.where(torch.abs(lam - 2.0) < 1e-8, torch.ones_like(lam), 2.0 - lam)
    yp = torch.where(torch.abs(lam) < 1e-8, torch.log1p(x),
                     ((1 + torch.clamp(x, min=0)) ** lam_nz - 1) / lam_nz)
    yn = torch.where(torch.abs(lam - 2.0) < 1e-8, -torch.log1p(-x),
                     -(((1 - torch.clamp(x, max=0)) ** lam2_nz) - 1) / lam2_nz)
    y = torch.where(pos, yp, yn)
    return (y - center[None, :]) / scale[None, :]


def _yj_inverse(z, lam, center, scale):
    y = z * scale[None, :] + center[None, :]
    lam = lam[None, :]
    lam_nz = torch.where(torch.abs(lam) < 1e-8, torch.ones_like(lam), lam)
    lam2_nz = torch.where(torch.abs(lam - 2.0) < 1e-8, torch.ones_like(lam), 2.0 - lam)
    xp = torch.where(torch.abs(lam) < 1e-8, torch.expm1(y),
                     torch.clamp(y * lam_nz + 1, min=1e-12) ** (1 / lam_nz) - 1)
    xn = torch.where(torch.abs(lam - 2.0) < 1e-8, -torch.expm1(-y),
                     1 - torch.clamp(1 - lam2_nz * y, min=1e-12) ** (1 / lam2_nz))
    return torch.where(y >= 0, xp, xn)


def _transform(scaler, x, inverse=False):
    def t(arr):
        return torch.as_tensor(np.asarray(arr, np.float32), device=x.device)

    if scaler.kind == "quantile-normal":
        fn = _quantile_inverse if inverse else _quantile_transform
        return fn(x, t(scaler.quantiles))
    if scaler.kind == "power-yj":
        fn = _yj_inverse if inverse else _yj_transform
        return fn(x, t(scaler.lambdas), t(scaler.center), t(scaler.scale))
    if scaler.kind == "robust":
        c, s = t(scaler.center), t(scaler.scale)
        return x * s[None, :] + c[None, :] if inverse else (x - c[None, :]) / s[None, :]
    if scaler.kind == "maxabs":
        s = t(scaler.scale)
        return x * s[None, :] if inverse else x / s[None, :]
    raise ValueError(f"unknown scaler kind {scaler.kind!r}")


def _apply(scaler, sample, n_dims, reshape, inverse, device, chunk=2_000_000):
    """Transform a tensor on its own device (-> tensor), or an array on
    ``device`` (-> numpy), in chunks of rows."""
    is_tensor = isinstance(sample, torch.Tensor)
    x = sample.to(torch.float32) if is_tensor else \
        torch.as_tensor(np.asarray(sample, np.float32), device=device)
    shape = x.shape
    if reshape:
        x = x.reshape(-1, n_dims)
    if len(x):
        x = torch.cat([_transform(scaler, x[i:i + chunk], inverse)
                       for i in range(0, len(x), chunk)])
    out = x.reshape(shape).to(torch.float32)
    return out if is_tensor else out.cpu().numpy()


def apply_scaler(sample, n_dims=3, scaler=None, tag="sample", reshape=False, verbose=True,
                 device="cuda"):
    """Apply a fitted scaler; identity when scaler is None.  A tensor is
    transformed on its own device and returned as a tensor; an array is
    transformed on ``device`` and returned as numpy."""
    if scaler is None:
        return sample
    start = time.time()
    if verbose:
        print("Applying scaler/transformer to " + tag, end="", flush=True)
    out = _apply(scaler, sample, n_dims, reshape, False, device)
    if verbose:
        print(f" ({time.time() - start:2.1f} s)")
    return out


def inverse_scaler(sample, n_dims=3, scaler=None, reshape=False, verbose=True,
                   device="cuda"):
    """Invert a fitted scaler (same tensor/array rules as apply_scaler)."""
    if scaler is None:
        return sample
    return _apply(scaler, sample, n_dims, reshape, True, device)
