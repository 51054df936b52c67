"""LM-driven lossless compression: compress -> v2 container -> decode."""
