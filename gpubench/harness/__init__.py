"""The general harness: manifest, clocks, device, trace reduction, work
counts, weights and comparisons."""
