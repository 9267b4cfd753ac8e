"""Tensor ops of the PyTorch port: TF1-legacy resizes, pixel packing, the fused tail."""
