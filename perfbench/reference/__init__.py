"""The benchmark's plain reference: the wavefront render and the material
fit of the scenes under test, in plain PyTorch and NumPy.

It imports nothing of the program under test and reads only the frozen
inputs (the scene YAML, the OBJ mesh and the HDR map in this folder). It
works out again everything the program derives from them: the draws
(threefry-2x32, as jax.random draws them), the camera, the mesh tables,
the wavefront's lane schedule, the shading, Russian roulette, the
retirement into the framebuffer, the film and, for the fit, the loss, its
gradients and Adam. Every tensor of floats is made in `dtype`: float32
for the reference, bfloat16 for the control.
"""
