from .metrics import (loss_function, latent_loss, loss_mapping,
                      compute_metric_bank, METRIC_NAMES)
from .roc import roc_rates, get_rates, auc_score, best_threshold, make_cut
from .deco import mass_deco, cum_distribution
from .bump import bump_hunter, bump_scan, generate_cuts
from .results import plot_results
from .jetid_eval import (make_labels, get_class_weight, get_sample_weights, upsampling,
                         downsampling, valid_accuracy, compo_matrix, discriminant,
                         multi_cuts, feature_removal)

__all__ = ["loss_function", "latent_loss", "loss_mapping", "compute_metric_bank",
           "METRIC_NAMES", "roc_rates", "get_rates", "auc_score", "best_threshold",
           "make_cut", "mass_deco", "cum_distribution", "bump_hunter", "bump_scan",
           "generate_cuts", "plot_results", "make_labels", "get_class_weight", "get_sample_weights", "upsampling",
           "downsampling", "valid_accuracy", "compo_matrix", "discriminant",
           "multi_cuts", "feature_removal"]
