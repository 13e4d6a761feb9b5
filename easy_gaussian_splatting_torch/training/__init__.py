"""Training layer: the config system, renderer selection and the inference
binning autotune."""
