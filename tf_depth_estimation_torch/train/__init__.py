"""Training of the PyTorch port: state, steps, loop, checkpoints and the experiment CLIs."""
