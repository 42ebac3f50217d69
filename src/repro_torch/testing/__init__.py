"""Test-support utilities (no runtime dependencies beyond numpy)."""
