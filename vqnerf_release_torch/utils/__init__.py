"""Output writers."""
