"""Consensus core: SHA-256 with an exposed compression, targets, headers."""
