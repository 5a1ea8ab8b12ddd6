"""The plain reference the port is judged against: NumPy and PyTorch
only, nothing of the program."""
