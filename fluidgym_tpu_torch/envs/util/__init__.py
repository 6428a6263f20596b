"""Shared environment utilities: resampling, observation extraction."""
