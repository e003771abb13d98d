"""Layers, encoders and the recurrent update block."""
