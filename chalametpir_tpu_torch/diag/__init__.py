"""Diagnostics of the port's kernels on the card."""
