"""Synthetic data of the port."""

from .synthetic import synthetic_words

__all__ = ["synthetic_words"]
