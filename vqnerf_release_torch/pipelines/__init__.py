"""End-to-end drivers."""
