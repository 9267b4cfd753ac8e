"""Experiment CLIs of the PyTorch port."""
