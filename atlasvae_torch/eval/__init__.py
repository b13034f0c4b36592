from .metrics import (loss_function, latent_loss, loss_mapping,
                      compute_metric_bank, METRIC_NAMES)

__all__ = ["loss_function", "latent_loss", "loss_mapping", "compute_metric_bank",
           "METRIC_NAMES"]
