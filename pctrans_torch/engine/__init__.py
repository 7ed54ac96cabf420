"""Train step and solver, eval step and CVPPP evaluator, checkpoints and the
Trainer (mirror of ``pctrans_tpu.engine``)."""
