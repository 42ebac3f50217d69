"""CTR model configurations (widths of the paper's models A-E)."""
