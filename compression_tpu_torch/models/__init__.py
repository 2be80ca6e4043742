"""Codec models (bmshj2018, with the host and the device coder)."""
