"""Benchmark models and the Flax parameter converter."""
