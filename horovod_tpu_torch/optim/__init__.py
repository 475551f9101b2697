"""Optimizer wrappers and broadcast helpers."""
