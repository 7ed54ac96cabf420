"""Training utilities: the monitor."""
