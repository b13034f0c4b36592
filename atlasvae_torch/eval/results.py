"""The evaluation pipeline of the VAE CLI (ref OE-VAE/plots.py:13-51 ``plot_results``).

Counterpart of ``atlasvae/eval/results.py``.  Pipeline: metric bank ->
[0,1] mapping -> optional mass decorrelation -> bump scan over cuts -> ROC
suite / mass sculpting / loss distributions -> optional
background-suppression cuts.  ``_evaluation_numbers`` computes every number
of it (the metric bank, the ROC rates and the scans on ``device``, the
rest on the host) and imports no matplotlib; ``_draw_results`` then draws
them all from host arrays.
"""

from .bump import _best_cut, _cut_samples, _draw_cuts, _draw_scan, _hunter_numbers, \
    _scan_numbers
from .deco import mass_deco
from .metrics import compute_metric_bank, loss_mapping
from .roc import get_rates
from ..parallel.mesh import is_writer
from ..utils.logging import StepTimes


def _on(flag):
    return (flag.upper() == "ON") if isinstance(flag, str) else bool(flag)


def _evaluation_numbers(y_true, x_true, x_pred, sample, n_dims, params, metrics, loss_metric,
                        apply_cuts="OFF", normal_losses="ON", decorrelation="OFF", npe=1000,
                        device="cuda", mesh=None):
    """Every number ``plot_results`` draws, as a dict: ``x_losses`` and
    ``metrics`` (the bank, mapped to [0, 1] and decorrelated as asked),
    ``best_loss``, ``scan`` and, at the best cut, ``cut_sample`` and
    ``hunter`` (None where the scan finds no cut), ``rates`` (each metric's
    ROC rates), ``curves`` (each metric's mass-sculpting JSD curves per
    class), ``cuts`` (the background-suppression cut samples under
    ``apply_cuts``, else None) and ``wall_ms``, each step's host-clock
    time (every step ends with its results on the host).  ``mesh`` shards
    the EMD/KSD metrics' jet axis over its ``data`` ranks."""
    from ..plotting.performance import _mass_curves
    step = StepTimes()
    # 'ON' means 2d (ref OE-VAE/plots.py:36-39); 'm', 'pt' and '2d' pick the
    # variant (ref OE-AAE/utils.py:107-145)
    deco = str(decorrelation)
    deco = "2d" if deco.upper() == "ON" else deco.lower()
    deco_active = deco in ("m", "pt", "2d")
    x_losses = step("metrics", compute_metric_bank, x_true, x_pred, params, metrics, n_dims,
                    sample, normal_losses=False, device=device, mesh=mesh)
    metrics = list(x_losses.keys())
    if _on(normal_losses) or deco_active:
        x_losses = {key: loss_mapping(val) for key, val in x_losses.items()}
    if deco_active:
        x_losses[loss_metric] = step("deco", mass_deco, y_true, sample, x_losses[loss_metric],
                                     deco=deco)
    x_loss = x_losses[loss_metric]
    scan = step("bump_scan", _scan_numbers, y_true, x_loss, loss_metric, sample,
                device=device)
    best_loss = cut_sample = hunter = None
    if scan is not None:
        best_loss = scan["best"]
        cut_sample = _best_cut(sample, x_loss, best_loss)
        hunter = step("bump_hunter", _hunter_numbers, cut_sample, npe=npe, device=device)
    rates = step("roc", lambda: {m: get_rates(y_true, x_losses[m], sample["weights"],
                                              device=device) for m in metrics})
    curves = step("mass_sculpting", _mass_curves, y_true, x_losses, sample["m"],
                  sample["weights"], rates)
    cuts = step("cuts", _cut_samples, y_true, sample, x_loss, loss_metric,
                device=device) if _on(apply_cuts) else None
    return dict(x_losses=x_losses, metrics=metrics, best_loss=best_loss, scan=scan,
                cut_sample=cut_sample, hunter=hunter, rates=rates, curves=curves, cuts=cuts,
                wall_ms=step)


def _draw_results(numbers, y_true, sample, sig_data, output_dir):
    """Draw ``_evaluation_numbers``' output, in the JAX package's order."""
    from ..plotting.performance import _draw_mass_correlation, _draw_roc, loss_distributions
    if numbers["scan"] is not None:
        _draw_scan(numbers["scan"], numbers["hunter"], sample, numbers["cut_sample"],
                   sig_data, output_dir)
    _draw_roc(numbers["rates"], output_dir)
    _draw_mass_correlation(numbers["curves"], output_dir)
    for metric in numbers["metrics"]:
        loss_distributions(y_true, numbers["x_losses"][metric], sample["weights"], metric,
                           output_dir, numbers["best_loss"])
    if numbers["cuts"] is not None:
        _draw_cuts(numbers["cuts"], sample, sig_data, output_dir)


def plot_results(y_true, x_true, x_pred, sample, n_dims, params, metrics,
                 loss_metric, sig_data, output_dir, apply_cuts="OFF",
                 normal_losses="ON", decorrelation="OFF", npe=1000,
                 mesh=None, device="cuda"):
    """The evaluation's numbers, then its plots under ``output_dir``;
    returns (best_loss, x_losses) as the JAX package does.  With ``mesh``
    every rank computes the numbers (the EMD/KSD metrics' jet axis split
    over the ``data`` ranks) and rank 0 alone draws."""
    print("\nPLOTTING PERFORMANCE RESULTS:")
    numbers = _evaluation_numbers(y_true, x_true, x_pred, sample, n_dims, params, metrics,
                                  loss_metric, apply_cuts, normal_losses, decorrelation, npe,
                                  device, mesh)
    if is_writer(mesh):
        _draw_results(numbers, y_true, sample, sig_data, output_dir)
    print()
    return numbers["best_loss"], numbers["x_losses"]
