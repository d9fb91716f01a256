"""Training: initializers, losses, metrics and optimizers (port of
``flexflow_tpu/training``)."""
