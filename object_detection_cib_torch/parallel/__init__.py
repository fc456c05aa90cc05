"""Data parallelism over the cards of one host or of several: the rank layout and its collectives."""
