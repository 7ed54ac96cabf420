"""Input data for the port: padded train targets (torch), the CVPPP and
synthetic datasets and the prefetching loader (numpy)."""
