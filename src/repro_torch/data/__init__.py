"""Synthetic CTR request streams."""
