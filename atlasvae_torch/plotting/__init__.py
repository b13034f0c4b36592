"""Performance numbers and plots.  matplotlib is imported inside the
functions that draw, never when a module is imported."""
