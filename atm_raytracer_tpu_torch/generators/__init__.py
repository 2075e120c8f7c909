"""Generators: the Fast (separable) renderer."""
