"""rlshaders_tpu_torch: the PyTorch and CUDA port of rlshaders_tpu.

The JAX package `rlshaders_tpu` stays the reference; this package mirrors
its layout (core, scene, accel, ops, bsdf, models, integrator) and function
names, imports torch and numpy, and never jax or rlshaders_tpu.

The ported slice renders opaque scenes of rlGgx and `standard` materials
under quad lights and a dome: `scene.demo.demo_scene(skin=False, device=...)`
then `integrator.wavefront.render(scene, accel, device=...)`. Ray queries on
CUDA tensors run the hand-written kernels of `ops/csrc/intersect.cu`, built
with nvcc at first use; on CPU tensors they run the plain BVH walk.
"""

__version__ = "0.1.0"
