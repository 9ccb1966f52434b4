"""Generators of every input from the seed; the mixes are the data files
beside them."""
