"""Losses, metrics and metric logging."""
