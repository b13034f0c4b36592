"""Performance numbers and plots.  matplotlib is imported inside the
functions that draw (``backend.pyplot``), never when a module is imported."""

from .bump import plot_bump_histogram, plot_stat_distribution, plot_tomography
from .history import plot_history
from .distributions import plot_distributions, sample_distributions

__all__ = ["plot_bump_histogram", "plot_stat_distribution", "plot_tomography",
           "plot_history", "plot_distributions", "sample_distributions"]
