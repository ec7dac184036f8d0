"""Utilities: profiling ranges, a stdlib PNG codec, matmul precision."""
