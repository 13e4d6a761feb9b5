"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain PyTorch
versions, one module per kernel:

- ``binkeys``      binning keys of both populations + exact ellipse/tile
                   test, one launch (csrc/binkeys.cu)
- ``tile_raster``  per-tile forward compositing (csrc/tile_forward.cu) and
                   its backward (csrc/tile_backward.cu), with their shared
                   per-warp cull (csrc/tile_cull.cuh)
- ``segments``     sorted-segment reductions of gradient rows: segmented
                   suffix sums (csrc/segsum_band.cu), compacted group sums
                   (csrc/segsum_compact.cu) and their expansion to one row
                   per Gaussian (csrc/monotone_expand.cu)
- ``group_reduce`` fixed-stride group sums (csrc/group_reduce.cu)
- ``sh_color``     the view-dependent SH colour and its gradient, one
                   launch each way (csrc/sh_color.cu)
- ``adam``         one grouped Adam step over every parameter group, one
                   launch (csrc/adam.cu)

Each wrapper takes the plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor, and counts its launches in a module
integer (``launches``; ``backward_launches`` for ``tiled_backward``,
``compact_launches`` for ``segsum_compact``, ``expand_launches`` for
``monotone_expand``; ``backward_launches`` for ``sh_color``'s backward).
"""
