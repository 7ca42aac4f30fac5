"""Plain references, one a configuration's ``estimate``: plain PyTorch
that imports nothing of the program and takes only the world."""
