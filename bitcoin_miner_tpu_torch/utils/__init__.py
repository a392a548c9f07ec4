"""Small host utilities."""
