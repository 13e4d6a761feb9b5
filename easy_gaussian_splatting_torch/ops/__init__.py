"""Tensor ops: quaternions, spherical harmonics, EWA projection, k-NN, the
oracle rasterizer and the tiled rasterizer over the hand-written kernels."""
