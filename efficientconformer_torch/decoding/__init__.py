"""Beam search decoding and n-gram LM fusion (the JAX package's decoding/)."""
