"""Pinhole projection, bilinear sampling and the warps of the PyTorch port."""
