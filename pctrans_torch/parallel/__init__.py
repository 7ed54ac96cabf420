"""Multi-card training helpers (one process per card)."""
