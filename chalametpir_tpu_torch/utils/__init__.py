"""Utilities of the port: telemetry."""
