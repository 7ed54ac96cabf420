"""Host-side CVPPP postprocess and metrics (numpy)."""
