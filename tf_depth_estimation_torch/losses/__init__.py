"""Loss terms, weight tables and the loss pipelines of the PyTorch port."""
