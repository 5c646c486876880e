"""Evaluation: image quality metrics."""
