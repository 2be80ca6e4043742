"""Codec models (this slice: bmshj2018 with the host coder)."""
