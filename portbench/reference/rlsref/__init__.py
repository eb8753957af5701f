"""rlsref: the benchmark's plain reference renderer.

A frozen copy of the parts of rlshaders_tpu_torch that render the
benchmark's scenes from their `.ass` files alone: the parser, the table
builder, the NumPy BVH builder, the plain BVH walk (every ray query; no
CUDA kernel, no native code), the wavefront integrator with its SSS stage,
the BSDFs, the random streams and the splat. Plain PyTorch and NumPy; it
imports nothing of the program, so a change to the program leaves it as
it is. `integrator.wavefront.render_tiles` takes `live_pixels`, to render
the samples of some pixels of a frame as the whole frame gives them.
"""
