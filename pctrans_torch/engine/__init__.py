"""Eval step and CVPPP evaluator (mirror of ``pctrans_tpu.engine``), eval
path only."""
