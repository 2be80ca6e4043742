"""Codec models: bmshj2018 and mbt2018 (the host and the device coder),
bls2017 in both archs (the host coder), and the training machinery."""
