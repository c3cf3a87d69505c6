"""Runnable examples of the port (counterparts of the reference's
``examples/``), each ``python -m repro_torch.examples.<name>``: the
quickstart, heterogeneous planning, collaborative serving and a small
training run.  Each runs on ``cuda`` unless ``--device cpu`` is given."""
