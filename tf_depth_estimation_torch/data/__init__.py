"""Host data of the PyTorch port: the colon pair loader, batching and synthetic data.

NumPy code, ported and not imported: ``tf_depth_estimation_tpu/data/__init__.py`` pulls
in JAX.
"""
