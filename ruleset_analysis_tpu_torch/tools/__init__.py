"""Tools over the port's outputs: ``python -m ruleset_analysis_tpu_torch.tools.<name>``."""
