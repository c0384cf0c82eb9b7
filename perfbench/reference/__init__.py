"""The plain reference the benchmark checks the port against: PyTorch and
NumPy only, nothing of the port."""
