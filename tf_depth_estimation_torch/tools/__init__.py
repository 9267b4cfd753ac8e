"""Probes of the card, run with ``python -m tf_depth_estimation_torch.tools.<name>``."""
