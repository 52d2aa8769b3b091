"""Dataset processors: the port's copies of ``bergen_tpu/data/processors``."""
