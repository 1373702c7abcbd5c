"""Plain reference of the benchmark's cells, in plain PyTorch and NumPy.

It imports nothing of clpathtracer_tpu_torch (nor JAX, nor the JAX
package) and takes nothing the program made: it works out every ray,
hit, shading row and light table again from the arrays the benchmark
made from the seed (inputs.py). Its arithmetic is a frozen copy of the
renderer's semantics: the pinhole camera chain, Moller-Trumbore with the
backface cull, the normal, mirror and Lambertian path shading with
next-event estimation."""
