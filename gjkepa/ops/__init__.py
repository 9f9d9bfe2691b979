"""Compute ops for the collision engine."""
