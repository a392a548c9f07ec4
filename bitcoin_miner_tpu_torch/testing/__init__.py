"""Test fixtures that also serve the chip smoke test."""
