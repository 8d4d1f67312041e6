"""Core tensor types, vector math, quaternions and the sampler."""
