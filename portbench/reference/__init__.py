"""Plain PyTorch and NumPy reference of what the benchmark's cells compute;
it imports nothing of the measured program."""
