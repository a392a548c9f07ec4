"""Nonce-range and extranonce2 arithmetic."""
