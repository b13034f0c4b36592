from .metrics import (loss_function, latent_loss, loss_mapping,
                      compute_metric_bank, METRIC_NAMES)
from .roc import roc_rates, get_rates, auc_score, best_threshold, make_cut
from .jetid_eval import (make_labels, get_class_weight, valid_accuracy, compo_matrix,
                         discriminant)

__all__ = ["loss_function", "latent_loss", "loss_mapping", "compute_metric_bank",
           "METRIC_NAMES", "roc_rates", "get_rates", "auc_score", "best_threshold",
           "make_cut", "make_labels", "get_class_weight", "valid_accuracy", "compo_matrix",
           "discriminant"]
