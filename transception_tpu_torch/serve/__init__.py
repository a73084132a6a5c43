"""Serving export of the port (serve.export)."""
