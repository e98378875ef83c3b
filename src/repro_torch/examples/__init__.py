"""Runnable examples on the port (``python -m repro_torch.examples.<name>``):
``quickstart``, ``train_lowprec`` and ``precision_assignment``."""
