"""Input data for the port: padded train targets (torch), the CVPPP, BBBC
and synthetic datasets and the prefetching loader (numpy)."""
