"""Correlation, sampling and geometry ops."""
