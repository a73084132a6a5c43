"""Utilities of the port (utils.profiling)."""
