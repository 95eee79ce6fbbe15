"""Analysis on top of the calculator and the dynamics (port of `tensoralloy_tpu/analysis/`)."""
