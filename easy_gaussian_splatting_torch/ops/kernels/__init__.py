"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain PyTorch
versions, one module per kernel:

- ``binkeys``      binning keys + exact ellipse/tile test (csrc/binkeys.cu)
- ``tile_raster``  per-tile forward compositing (csrc/tile_forward.cu) and
                   its backward (csrc/tile_backward.cu)
- ``segments``     segmented suffix sums of gradient rows (csrc/segsum_band.cu)

Each wrapper takes the plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor, and counts its launches in a module
integer (``launches``; ``backward_launches`` for ``tiled_backward``).
"""
