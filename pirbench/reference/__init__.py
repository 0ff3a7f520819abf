"""The plain reference of the benchmark's check: NumPy and plain PyTorch,
importing nothing of the program under test."""
