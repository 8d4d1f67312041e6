"""The plain reference of the many-sphere scenes (the final scene of Ray
Tracing in One Weekend): pooled spheres found by a dense scan, and the
dielectric lobe beside the shared reference's lambertian and metal lobes,
in plain PyTorch and NumPy.

It reads the frozen scene YAML only and imports nothing of the program
under test, nor JAX: from the shared reference (`perfbench.reference`) it
takes the draws (threefry), the camera basis, the wavefront's lane
schedule, Russian roulette, the capped retirement, the lambertian and
metal lobes, the background and the film; `scene`, `trace` and `render`
here add the spheres and the dielectric. Every tensor of floats is made
in `dtype`: float32 for the reference, bfloat16 for the control.
"""
