"""Training-side helpers the serving slice needs (snapshot file writes)."""
