"""The paper's figure and table scripts on the port (``python -m
repro_torch.paper.<name>``): ``fig5_variance_lost``, ``fig5c_chunk_sweep``,
``table1_precisions`` (closed-form analysis, host arithmetic) and
``fig6_convergence`` (training on ``cuda``, or ``--device cpu``)."""
