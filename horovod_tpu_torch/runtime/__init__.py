"""Data-plane programs of the port."""
