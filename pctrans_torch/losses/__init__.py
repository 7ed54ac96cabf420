"""Loss stack of the dense criterion (mirror of ``pctrans_tpu.losses``):
Hungarian matcher, re-id contrast, discriminative embedding loss and
``SetCriterion``."""
