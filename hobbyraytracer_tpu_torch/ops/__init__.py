"""Batched tensor ops: textures, materials, camera, film, intersection."""
