"""Performance numbers of a classifier or a score.

Counterpart of ``atlasvae/plotting/performance.py``, for now its one function
that draws nothing: ``background_rejection``.  The drawing functions
(``roc_curves``, ``class_distributions``, ...) follow with the evaluation
half of the VAE CLI; they will import matplotlib inside their bodies, so
that this module loads where matplotlib is not installed.
"""

import numpy as np

from ..eval.roc import roc_rates


def background_rejection(y_true, y_prob, weights=None, sig_eff=(90, 80, 70), device="cuda"):
    """Background rejection 1/eps_bkg at fixed signal efficiencies.  Returns
    {eff_percent: rejection} and prints one line each."""
    y_true = np.asarray(y_true)
    score = np.asarray(y_prob[:, 0] if np.ndim(y_prob) > 1 else y_prob)
    w = np.ones(len(y_true)) if weights is None else np.asarray(weights)
    # roc_rates treats class 0 as signal
    fpr, tpr, _ = roc_rates(y_true, score, w, device)
    out = {}
    for val in sig_eff:
        idx = np.searchsorted(tpr, val / 100.0, side="left")
        rej = 1.0 / max(float(fpr[min(idx, len(fpr) - 1)]), 1e-30)
        out[val] = rej
        print(f"BACKGROUND REJECTION AT {val}%: {rej:>6.0f}")
    return out
