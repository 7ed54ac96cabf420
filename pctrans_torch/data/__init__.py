"""Input data for the port: padded train targets (torch) and synthetic
scenes (numpy)."""
