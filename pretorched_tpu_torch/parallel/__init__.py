"""Evaluation steps."""
