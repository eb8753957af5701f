"""rlshaders_tpu_torch: the PyTorch and CUDA port of rlshaders_tpu.

The JAX package `rlshaders_tpu` stays the reference; this package mirrors
its layout (core, scene, accel, ops, bsdf, models, integrator, io, utils,
cli) and function names, imports torch and numpy, and never jax or
rlshaders_tpu.

The ported slices render scenes of rlGgx, rlDisney, rlSkin and `standard`
materials under quad and disk lights and a dome: rough refraction and
transparent shadows, subsurface scattering by probe rays, and MayaFile
textures, planar projections and bump3d maps (PNG images; JPEG is not
decoded yet). Meshes' trace sets fold into visibility bits 8 and up, and
`accel.trace.build_trace_set` builds the query structure of one set.
`python -m rlshaders_tpu_torch.cli render scene.ass -o out.exr` renders to
EXR (`cli` also runs a golden-image testsuite); from Python,
`scene.demo.demo_scene()` or `scene.build.build(path)`, then
`integrator.wavefront.render(scene, accel)`. Entry points put the scene on
the card unless asked for the CPU (`device="cpu"`, `--device cpu`);
`render` runs where the scene lives. Ray queries on CUDA tensors run the
hand-written kernels of `ops/csrc/intersect.cu`, built with nvcc at first
use; on CPU tensors they run the plain BVH walk.
"""

__version__ = "0.1.0"
