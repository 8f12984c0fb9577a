"""Traffic generators: each reads a mix's parameters from ``traffic/<mix>.json``."""
