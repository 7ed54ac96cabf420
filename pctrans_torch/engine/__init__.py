"""Train step and solver, eval step and CVPPP evaluator (mirror of
``pctrans_tpu.engine``)."""
