"""Data streams of the port."""
