"""Decoding and dataset helpers."""
