"""Data parallelism over the cards of one host: the rank layout and its collectives."""
