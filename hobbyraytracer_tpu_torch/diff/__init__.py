"""Inverse rendering: the differentiable material and vertex fit."""
