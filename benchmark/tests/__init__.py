"""CPU tests of the benchmark (and one on the card)."""
