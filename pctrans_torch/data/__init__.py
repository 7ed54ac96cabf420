"""Input data for the port (numpy)."""
