"""Model layer: Gaussian parameter state and the forward render."""
