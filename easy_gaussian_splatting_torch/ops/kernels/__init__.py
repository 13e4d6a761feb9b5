"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain PyTorch
versions, one module per kernel:

- ``binkeys``      binning keys + exact ellipse/tile test (csrc/binkeys.cu)
- ``tile_raster``  per-tile forward compositing (csrc/tile_forward.cu)

Each wrapper takes the plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor, and counts its launches in the
module's ``launches`` integer.
"""
