"""Evaluation and training steps."""
