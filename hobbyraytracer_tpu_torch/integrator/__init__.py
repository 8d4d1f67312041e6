"""Integrators: the regenerative wavefront pool (the main path)."""
