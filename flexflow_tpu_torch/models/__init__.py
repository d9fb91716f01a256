"""Model builders over ``FFModel`` (port of ``flexflow_tpu/models``)."""
