"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints progress and its time; any failure raises and exits
nonzero):

1. the card's name and power limit (nvidia-smi); refuses to run without a
   CUDA device;
2. builds the ray-query kernels (ops/csrc/intersect.cu) and the random
   draws' kernels (ops/csrc/rng.cu) with nvcc into one library;
3. holds each kernel against its plain PyTorch version (accel/bvh.py) on
   the card: on every query of a 256x256 demo frame (camera, GI and shadow
   rays), on random rays with dead lanes, exclude_tri and each visibility
   bit, and on random rays through a 12,000-triangle soup (too large for
   shared memory: the global path); prints mismatch counts, the launches
   of each table path, the times of both and the bound;
4. renders demo_scene(skin=False) at 256x256, AA 2, through the kernels,
   with the kernels' launch counts reset first and the plain walk barred
   from CUDA tensors; prints seconds per frame, the query counts and the
   rate;
5. renders the demo at 32x32 on the card and on the CPU (plain walk) and
   compares;
6. holds both kernels to the plain walk on every query of a 48x48, AA 3
   frame of scenes/glass_sphere.ass at a refraction depth of 1 (the
   scene's is 3) with Russian roulette from refraction depth 1 (march
   steps with finite t_max and exclude = the previous hit, roulette-dead
   lanes with t_max 0, launches with no live lane: each kind is counted
   and must occur; the frame was 64x64 at depth 3 until the phase took
   142-190 s of the script's 1,200; 48x48 kept the launches, whose count
   and longest walks set the plain walk's time, and depth 1 cuts them);
   times the
   kernels (not the plain walk: one pass takes minutes; PERF.md has it),
   checks the kernels' device time against torch.profiler's sum of their
   launches, prints the dead lanes of those queries (launches with no live
   lane, 32-lane groups with a live lane), and profiles a 128x128 frame,
   one full tile of the timed frame (the card's activity only, read from
   the raw events: the device time by kernel, its busy share);
7. renders the glass scene at 256x256, AA 3, its own options, through the
   kernels (counts reset, plain walk barred); prints seconds per frame, the
   query counts, the rate and the refraction AOV;
8. the stage timing of the TPU tool tools/trace_decomp2.py (j_walk): each
   kernel alone, warm, on 262,144 coherent camera rays of the glass scene
   and 262,144 incoherent cosine-bounce rays from their hits, beside its
   byte and operation bounds;
9. renders the glass scene at 12x12 on the card and on the CPU, at phase
   6's refraction depth of 1, and compares;
10. holds both kernels to the plain walk on every query of a 64x64, AA 2
   frame of scenes/skin_closeup.ass (the SSS probe stage: probes with an
   exclude and foreign-hit termination, the probe-hit light columns) and
   of a 64x64, AA 2 frame of demo_scene() with its rlSkin blob; prints the
   rays with an exclude and the dead lanes; times both kernels on the skin
   frame's queries (the `skin` shape) beside the plain walk and the bound;
11. renders scenes/skin_closeup.ass at its own options (512x512, AA 2)
   through the kernels (counts reset, plain walk barred); checks every
   plane and that the sss AOV is above 0; prints seconds per frame, the
   rays, the launches per kernel, and the device busy share of one
   profiled tile (128x128, AA 2);
12. renders the skin scene at 32x32, AA 2 on the card and on the CPU and
   compares (64x64 until the script neared its time limit);
13. holds both kernels to the plain walk on every query of a 64x64, AA 3
   frame of scenes/disney_spheres.ass (six rlDisney spheres: curved
   meshes, GTR1 and anisotropic glossy rays); prints the table path, the
   rays, the dead lanes and the launches by table path; times both kernels
   on those queries (the `disney` shape) beside the plain walk and the
   bound;
14. renders scenes/disney_spheres.ass at its own options (256x256, AA 3)
   through the kernels (counts reset, plain walk barred); checks every
   plane and that the indirect_specular AOV is above 0; prints seconds per
   frame, the rays, the launches per kernel and the rate, and profiles one
   128x128, AA 3 tile (the card's activity only);
15. renders the Disney scene at 32x32, AA 2 on the card and on the CPU and
   compares;
16. times the JAX package's Disney workload (bench.py `step`: a 1920x1080
   material grid, 8 samples a pixel, each a specular and a diffuse sample
   with eval and both MIS pdfs) through the port's bsdf/disney.py in eager
   torch, clearcoat 0.8 and 0.0, with CUDA events after a warm-up; prints
   Gsamples/s counted as bench.py counts them. A measurement, not a gate.
17. holds both kernels to the plain walk on every query of a 64x64, AA 3
   frame of scenes/textured_disk.ass at its own GI samples (3x3: textured
   backdrop, floor and panels, four balls, two disk lights and a dome);
   prints the table path, the rays, the dead lanes and the launches by
   table path; times both kernels on those queries (the `textured` shape)
   beside the plain walk and the bound;
18. renders scenes/textured_disk.ass at its own options (256x256, AA 3)
   through the kernels (counts reset, plain walk barred); checks every
   plane and that the direct_diffuse AOV is above 0; prints the texture
   table's bytes, seconds per frame, the rays, the launches per kernel
   and the rate, and profiles one 128x128, AA 3 tile (the card's activity
   only);
19. renders the textured scene at 32x32, AA 2 on the card and on the CPU
   and compares;
20. the command line on the card: `cli.main(["render",
   "scenes/textured_disk.ass", "-o", ..., "--passes", "2", "--aovs",
   "--profile"])` at the scene's own options, with the kernels' launch
   counts reset first; reads every EXR back (finite, the frame's shape),
   holds the beauty to the float64 mean of two direct renders at seeds 0
   and 7919 within half-float rounding, and times what the command adds
   around `render` (the float64 mean and host copy of the planes, the EXR
   writes); prints the passes' seconds, the stage lines, the stats line,
   the profile's top kernels and the launches;
21. trace sets: the textured scene with `trace_sets "setA"` on four of its
   eight polymeshes (the floor among them); both kernels held to the plain
   walk on every query of a 64x64, AA 3 frame rendered through each
   subset accel of `build_trace_set` (inclusive, exclusive), and timed on
   those queries (the `trace_sets_inclusive` and `trace_sets_exclusive`
   shapes) beside the plain walk and the bound;
22. `cli mkdir`, `list`, `test` and `display` on a suite written to a
   temporary directory: the Disney and textured scenes with the port's own
   card renders as goldens (both pass, rmse under 1e-3) and the textured
   scene with the Disney golden (fails); checks the listing, the report's
   rows and that every sheet decodes;
23. `parallel/mesh.py::render_sharded` at world size 1 over NCCL in this
   process (a FileStore group, destroyed after): the demo frame of phase 4
   through the kernels (counts reset, plain walk barred), every plane held
   to `render`'s frame on the card by the CUDA vs CPU tolerance (the
   splat's atomics move the last bits of both), the ray counts equal;
   both frames timed in three interleaved pairs; bench.py's 1080p Disney
   step through `sharded_shade_step` on the (1,) mesh, held to
   `shade_step` and timed (Gsamples/s as phase 16 counts them);
24. world size 2 over gloo, two processes on cuda:0 (`launch(...,
   backend="gloo", same_device=True)`): demo_scene() with its rlSkin blob
   at 256x256, AA 2 through `render_sharded` at tile_pixels 16384 (two
   tiles a rank) and 24576 (three tiles padded to four), each held to the
   single-process frame at its tile size by the same tolerance; both
   kernels launched on every rank; the ranks' summed ray counts equal to
   the single process's plus the padding tile's; `sharded_shade_step` on
   the (1, 2) and (2,) meshes over the 1080p batch, SPP 8, within 1e-5 of
   the same arithmetic by `shade_step` in one process;
25. the committed scenes/data/grid.jpg and logo.jpg decoded without PIL
   and held to the SHA-256 of PIL's decode; scenes/textured_disk.ass with
   its images named .jpg rendered at its own options through the kernels
   (counts reset, plain walk barred), and at 32x32 on the card and on the
   CPU, compared;
26. the dense Disney scene (tools/make_dense_disney.py: the six balls at
   512 x 256 quads, 1,572,866 triangles) built on the card through
   `build(nodes)` and `trace.build`, whose native builder (accel/native.py)
   is compiled first: the triangle and node counts, the table bytes and
   the table path (it must be "global"), and the seconds of the node list,
   the scene build, the accel, the native BVH build alone and `pack`
   alone; the tree's boxes and links checked exact; on a 64 x 32-quad copy
   (24,578 triangles) and on one full ball, the plain builder
   (accel/bvh.py) held to the native one compiled without fused
   multiply-adds (five arrays equal, every leaf the same set of
   triangles), the path's native tree checked exact and compared, both
   builders timed;
27. both kernels held to the plain walk on every query of a 64x64, AA 3
   frame of the dense scene, every launch on the global path, and timed
   on those queries (the `dense` shape) beside the plain walk and the
   bound;
28. the dense scene at its own options (256x256, AA 3) through the kernels
   (counts reset, plain walk barred); checks every plane, the
   indirect_specular AOV above 0 and every launch on the global path;
   prints seconds per frame, the rays, the launches per kernel and the
   rate, and profiles one 128x128, AA 3 tile (the card's activity only);
   then a 16x16, AA 1 frame on the card and on the CPU, compared;
29. every committed file of scenes/data/modes/ (tools/make_image_modes.py:
   PNG of every colour type, depth and Adam7, progressive, CMYK and
   RGB-coded JPEG, TIFF, BMP and GIF, and a 2048x2048 progressive JPEG)
   decoded without PIL through `texture.decode_image` and held to the
   SHA-256 of PIL's decode; its bytes, shape and host milliseconds;
30. scenes/textured_disk.ass at its own options (256x256, AA 3, 3x3 GI
   samples) with its three images replaced, through the kernels (counts
   reset, plain walk barred): frame A the 2048x2048 progressive JPEG, an
   LZW TIFF with predictor 2 and an Adam7 palette PNG, frame B a GIF, a
   4-bit BMP and a CMYK JPEG; each frame must launch 16 nearest and 60
   any-hit queries, prints its build seconds, texture-table bytes and
   seconds per frame, and is compared at 16x16 on the card and the CPU
   (32x32, then 24x24, as the script neared its time limit);
31. every committed file of scenes/data/formats/
   (tools/make_image_formats.py: JPEG- and CCITT-compressed TIFF, DIB,
   TGA, PNM and PFM, DDS, SGI, PCX, QOI, and a 2048x2048 DXT1 DDS)
   decoded without PIL and held to the SHA-256 of PIL's decode, as in 29;
32. the textured scene as in 30 with frame C (the 2048x2048 DXT1 DDS, a
   run-length TGA, a JPEG-compressed TIFF) and frame D (a QOI, a palette
   PCX, a Group 4 TIFF); phases 31-32 must take 60 s at most;
33. every committed file of scenes/data/formats_b/
   (`tools/make_image_formats.py formats_b`: BC4, BC6H and BC7 DDS, BLP1
   and BLP2, ICO, CUR, ICNS, IM, MSP and XBM, and a 2048x2048 BC7 DDS in
   which every mode and partition occurs) decoded without PIL and held to
   the SHA-256 of PIL's decode, as in 29, with each file's milliseconds;
34. the textured scene as in 30 with frame E (the 2048x2048 BC7 DDS, a
   BC6H SF16 DDS, a BLP2 DXT3) and frame F (an ICO whose largest entry is
   a 32-bit BMP, an it32 run-length ICNS, a palette IM), each also held
   to the plain walk on every query of a 24x24 frame at the scene's own
   AA 3 and GI samples (0 mismatches for both kernels; 32x32 until PR
   17); phases 33-34 must take 60 s at most;
35. every committed file of scenes/data/formats_c/
   (`tools/make_image_formats.py formats_c`: SPIDER from "F" and "L",
   big-endian and a stack; lossless WebP with each VP8L transform and the
   colour cache; lossy WebP at quality 5 to 100 and odd sizes, with the
   simple filter, 8 partitions, sharpness, segments and filter deltas of
   the tool's own VP8 writer; VP8X with alpha, an ICC profile and EXIF;
   and a 2048x2048 lossy WebP, its host decode on a line of its own)
   decoded without PIL and held to the SHA-256 of PIL's decode, as in 29;
36. the textured scene as in 30 with frame G (the 2048x2048 lossy WebP, a
   lossless RGBA WebP, a lossy WebP with alpha) and frame H (a SPIDER, a
   palette lossless WebP, a quality-5 lossy WebP), each held to the plain
   walk as in 34; phases 35-36 must take 90 s at most (the lossy
   decoder's boolean decoding is a Python loop);
37. every committed file of scenes/data/formats_d/
   (`tools/make_image_formats.py formats_d`: J2K and JP2 files in the five
   progression orders, with tiles, precincts, quality layers, offsets,
   POC and tile-parts (the cinema profiles), the 5/3 and 9/7 wavelets,
   RCT and ICT, signed, I;16 and LA components, a palette JP2 and an ICNS
   with a JP2 entry; an animated lossy WebP whose first frame sits inside
   a larger canvas and an animated lossless WebP; and a 2048x2048 9/7 JP2
   of three quality layers, its host decode on a line of its own) decoded
   without PIL, JPEG 2000's tier-1 by the native code g++ builds there,
   and held to the SHA-256 of PIL's decode, as in 29;
38. the textured scene as in 30 with frame I (the 2048x2048 JP2, a
   lossless RGBA JP2, the animated lossy WebP) and frame J (the palette
   JP2, a tiled RPCL J2K with an image offset, the animated lossless
   WebP), each held to the plain walk as in 34; phases 37-38 must take
   90 s at most;
39. every committed file of scenes/data/formats_e/
   (`tools/make_image_formats.py formats_e`: still AVIF as PIL writes it,
   AV1 intra frames in each subsampling, full and limited range, quality
   0 to 100 (lossless), speed 0 to 10, explicit and automatic tiles,
   RGBA with and without premultiplied alpha, palette and intra block
   copy, CDEF, delta q and lf, loop restoration, 1x1 and 17x33 sizes,
   ICC, EXIF and XMP; and a 2048x2048 AVIF of 4x2 tiles, its host decode
   on a line of its own) decoded without PIL, the AV1 tiles by the native
   code g++ builds there, and held to the SHA-256 of PIL's decode, as in
   29;
40. the textured scene as in 30 with frame K (the 2048x2048 AVIF, an RGBA
   AVIF, a premultiplied RGBA AVIF) and frame L (a lossless 4:4:4 AVIF, a
   4:0:0 AVIF with alpha, a limited-range 4:2:2 AVIF), each held to the
   plain walk as in 34; phases 39-40 must take 60 s at most;
41. every file of scenes/bombs/ (`tools/make_image_formats.py bombs`: a
   header-only file past PIL's decompression-bomb limit for each of the
   23 formats the port decodes, and a whole 1-bit PNG of 13,380 x 13,380
   pixels) raises ValueError naming the limit, before a pixel is
   decoded; then every committed file of scenes/data/formats_f/
   (`tools/make_image_formats.py formats_f`: AVIF with quantizer
   matrices, film grain, PIL's image sequences and hand-built grids, with
   alpha, at each subsampling and odd sizes; a 2048x2048 AVIF with film
   grain and a 2048x2048 grid of four 1024x1024 tiles) decoded without
   PIL and held to the SHA-256 of PIL's decode, as in 29;
42. the textured scene as in 30 with frame M (the 2048x2048 film-grain
   AVIF, an RGBA image sequence, a quantizer-matrix AVIF) and frame N
   (the 2048x2048 grid, a 4:4:4 quantizer-matrix AVIF with alpha, an
   odd-size film-grain AVIF with chroma scaled from luma), each held to
   the plain walk as in 34; phases 41-42 must take 60 s at most;
43. every committed file of scenes/data/formats_g/
   (`tools/make_image_formats.py formats_g`: a 1024x1024 float32 height
   map under Deflate with the floating-point predictor, signed and float
   TIFF of every layout PIL opens, YCbCr TIFF outside JPEG at every
   subsampling libtiff converts, sYCC JPEG 2000, PSD of every mode PIL
   opens, AVIF frames libavif scales to their ispe or track size)
   decoded without PIL and held to the SHA-256 of PIL's decode, with the
   host milliseconds of each file, as in 29;
44. the textured scene as in 30 with frame O (the float height map, a
   16-bit signed TIFF, an RLE RGB PSD with a layer section) and frame P
   (a 2x2-subsampled YCbCr LZW TIFF, an sYCC JP2, an AVIF libavif scales
   to its ispe), each held to the plain walk as in 34; phases 43-44 must
   take 60 s at most;
45. every committed file of scenes/data/formats_h/
   (`tools/make_image_formats.py formats_h`: a 1024x1024 LAB TIFF under
   ZSTD, a 512x512 ZSTD TIFF tiled 256x256 with predictor 2, LAB PSD and
   TIFF, Sun rasters of every depth raw and run-length coded, XPM, FTEX,
   DCX, GIMP brushes, IMT, McIdas, PIXAR and an XV thumbnail) decoded
   without PIL and held to the SHA-256 of PIL's decode, with the host
   milliseconds of each file and, for the LAB ZSTD TIFF, the milliseconds
   of its ZSTD strips and of its LAB conversion apart, as in 29;
46. the textured scene as in 30 with frame Q (the LAB ZSTD TIFF, the
   tiled ZSTD TIFF, a 24-bit RLE Sun raster) and frame R (an RLE LAB PSD,
   an XPM, a DXT1 FTEX), each held to the plain walk as in 34; phases
   45-46 must take 60 s at most;
47. every committed file of scenes/data/formats_i/
   (`tools/make_image_formats.py formats_i`, hand writers: FLI and FLC of
   every sub-chunk type, a 640x480 FLC, a 768x512 PhotoCD and its two
   turned orientations, FITS of each BITPIX, axes and GZIP_1 tiles, raw
   and JPEG IPTC, and damaged JPEGs that libjpeg-turbo decodes: a bad
   Huffman code, a marker hit mid-scan, a lost EOI, a restart resync,
   blocks whose SIMD IDCT differs from the C routine, progressive scans
   damaged and cut for block smoothing, a JPEG TIFF strip) decoded
   without PIL and held to the SHA-256 of PIL's decode, with the host
   milliseconds of each file, as in 29;
48. the textured scene as in 30 with frame S (the 640x480 FLC, the
   PhotoCD, the block-smoothed cut progressive JPEG) and frame T (the
   512x512 16-bit GZIP_1 FITS, an RGB IPTC band, the baseline JPEG whose
   samples follow the SIMD IDCT), each held to the plain walk as in 34;
   phases 47-48 must take 60 s at most;
49. the random draws' kernels (ops/csrc/rng.cu: rls_rng_threefry,
   rls_rng_sobol_stream, rls_rng_sobol_at): every public draw of
   core/rng.py on the card at the shapes of one tile of portbench's
   disney.frame512 cell (2,359,296 lanes: the tile's camera uniform,
   uniform2, stratified2_flat and sobol2_flat, and bits, stratified2,
   stratified2_flat at s = 3, sobol2_rep, sobol2_at with an int purpose
   and with the SSS stage's tensor of purposes, sobol2), each one launch
   of its kernel and held bit for bit to core/rng.py's plain int64 code on
   the same inputs on the CPU (the values that differ from that code run
   on the card counted: torch's CUDA division by a scalar multiplies by
   its reciprocal), timed (device_ms, call_ms, plain_ms) beside its bound
   (bytes, or the operations of rng.cuh at the card's issue rate), with
   each kernel's instructions in the SASS; then the disney_grid frame at
   512x512, AA 3 (one tile) with the launch counts reset and the tracer's
   counters on: the draws' launches a kernel equal to the tile's mix
   (RNG_TILE), its values equal to theirs, every value drawn by a kernel;
   and the tile through `TileRenderer.render_tile_at` bit-equal in every
   plane to the same tile with the plain draws forced in;
50. the lobes' kernels (ops/csrc/bsdf.cu: rls_bsdf_eval_diffuse,
   rls_bsdf_sample_diffuse, rls_bsdf_eval_specular,
   rls_bsdf_sample_specular, rls_bsdf_sample_refract): the disney_grid
   frame at 512x512, AA 3 (one tile) with every lobe call of
   models/dispatch.py run by its kernel and then by the eager torch code
   on the same inputs on the card (the lanes that differ counted, with
   their largest ulp distance; at most 0.2% of an entry's lanes beyond 4
   ulps and 1e-4 relative), the launch
   counts reset and the tracer's counters on: one launch a call and every
   lobe lane handled by a kernel; then portbench's glass scene up to its
   first refraction family (9,437,184 lanes), held the same way; the
   largest call of each entry point (the frame's 9,437,184-lane light
   columns and BSDF families, the glass family) timed (device_ms, call_ms,
   plain_ms) beside its bound (the bytes of its branches, or their
   operations at the card's issue rate).

Every main-path render above (phases 4, 7, 11, 14, 18, 20, 23-25, 28,
30-48, 49's frame and 50's) resets the launch counts of the three
kernel sets first and reads them.

Each kernel is timed two ways at each shape (the demo frame's queries, the
glass frame's, the skin frame's, the Disney frame's, the textured frame's,
the two trace-set frames', the dense Disney frame's, the two j_walk sets):
`device_ms`, the shape's queries
captured in one CUDA graph whose replays are timed with CUDA events (what
the card spends; the wrappers' host time is paid once, at capture), and
`call_ms`, the same queries as eager wrapper calls timed with CUDA events
(what the main path pays per call). The share of the bound is taken from
`device_ms`. A kernel's top-level `ms` is the `call_ms` of the demo
frame's queries, the measure the key has always had; a comparison of
device times reads `shapes[...]["device_ms"]`.

The last three lines of the output are: a JSON object with one entry per
kernel (with, per shape, its launches, device_ms and call_ms; and the
launches of each main-path run, `launches_demo` ... `launches_cli`,
`launches_mesh` for phases 23-24, `launches_jpeg` for phase 25,
`launches_dense` for phase 28, `launches_images` for phase 30,
`launches_formats` for phase 32, `launches_formats_b` for phase 34,
`launches_formats_c` for phase 36, `launches_formats_d` for phase 38,
`launches_formats_e` for phase 40, `launches_formats_f` for phase 42,
`launches_formats_g` for phase 44, `launches_formats_h` for phase 46,
`launches_formats_i` for phase 48, `launches_frame512` for phase 49's
frame, `launches_lobes` for phase 50's frames, whose sum is `launches`;
after the two query kernels, one entry per draw kernel with its
mismatches, the device, call, plain and bound ms of the frame512 tile's
draws of it (of the SSS columns draw for rls_rng_sobol_at, which the tile
does not launch) and each draw as a shape; then one entry per lobe kernel
with its differing lanes and largest ulp distance, the device, call,
plain and bound ms of its largest call and each timed call as a shape);
the card's
name
and power limit as nvidia-smi prints them; and {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from functools import partial

import numpy as np
import torch

DEVICE = "cuda"
SIZE = 256          # frame width and height of the main-path render
AA = 2
SEED = 0
GLASS = "scenes/glass_sphere.ass"
GLASS_AA = 3
GLASS_CHECK = 48    # width and height of the glass frame held to the walk
GLASS_CHECK_DEPTH = 1  # its GI_refraction_depth (the scene's is 3)
GLASS_RR = 1        # its roulette start, so roulette still cuts lanes
PROFILE_SIZE = 128  # the profiled frames: one full tile at AA 2 or 3
GLASS_CPU = 12      # width and height of the glass CUDA vs CPU frames
SKIN = "scenes/skin_closeup.ass"
SKIN_CHECK = 64     # width and height of the skin frames held to the walk
SKIN_CPU = 32       # width and height of the skin CUDA vs CPU frames
DISNEY = "scenes/disney_spheres.ass"
DISNEY_AA = 3
DISNEY_CHECK = 64   # width and height of the Disney frame held to the walk
DISNEY_CPU = 32     # width and height of the Disney CUDA vs CPU frames
TEXTURED = "scenes/textured_disk.ass"
TEXTURED_AA = 3
TEXTURED_CHECK = 64  # width and height of the textured frame held to the walk
TEXTURED_CPU = 32   # width and height of the textured CUDA vs CPU frames
CLI_TILE = 8192     # `cli render`'s and `cli test`'s --tile default
CLI_AOVS = ["direct_diffuse", "direct_specular", "indirect_diffuse",
            "indirect_specular", "refraction", "sss"]
# the textured scene's polymeshes in trace set "setA" (phase 21)
TRACE_SET_MESHES = ("floor", "inv_panel", "bump_ball", "dsy_ball")
# bench.py's Disney BSDF step: a material grid of this size, SPP samples a
# pixel (each a specular and a diffuse BSDF sample)
STEP_W, STEP_H, STEP_SPP = 1920, 1080, 8
JWALK_RAYS = 262144
# phase 24's tile sizes at world size 2: 4 tiles (2 a rank), and 3 tiles
# padded to 4 (a padding tile, traced and dropped)
MESH_TILES = (16384, 24576)
MESH_TIMEOUT_S = 300    # a launch of phase 24: ends a hung rank
# SHA-256 of PIL's RGB decode of the committed JPEG textures (pinned by
# tests/test_torch_jpeg.py)
JPEG_DIGESTS = {
    "scenes/data/grid.jpg":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/logo.jpg":
        "6ca72db18beca40ae8d32c3fe2421a339667c534ed778bf6106a07b9db5df803",
}
# SHA-256 of PIL's RGB decode of every file of scenes/data/modes (printed
# by tools/make_image_modes.py; pinned by tests/test_torch_gpu.py too)
MODE_DIGESTS = {
    "scenes/data/modes/grid.gif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_8bit_topdown_v5.bmp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_grey16.png":
        "c1f7d702a80ae5e7dc52d62ef2577cbbb25c045d6dda3a49a872130518f48cc0",
    "scenes/data/modes/grid_grey1_adam7.png":
        "363cb8b7a0c1362aad878f833388374ba3cda6a58460528ef537cfcf74ecbe8b",
    "scenes/data/modes/grid_grey4.png":
        "240bf383fa47ede915297c2869089a394e4105c00ed50916a793c4a13608361f",
    "scenes/data/modes/grid_minwhite1.tif":
        "363cb8b7a0c1362aad878f833388374ba3cda6a58460528ef537cfcf74ecbe8b",
    "scenes/data/modes/grid_os2_1bit.bmp":
        "65bd463b46b3fa067437a411131c777912210f14c48fa231d4cb863dc1650a5a",
    "scenes/data/modes/grid_palette_packbits.tif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_progressive.jpg":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/modes/grid_rgb.jpg":
        "e16ee891b5d66530e8d707cb424ae0a13ba198a67660c2bfc84eb3014c2e912d",
    "scenes/data/modes/grid_rgb16.png":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_rgb16_lzw_pred2_mm.tif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_rle8.bmp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/grid_tiles_deflate_planar2_mm.tif":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/modes/logo_4bit.bmp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_565_bitfields.bmp":
        "4b38b26737b78000b0c0b48a24e452e82394331479f703e4709c00030f6a9aaa",
    "scenes/data/modes/logo_cmyk.jpg":
        "9c0106c01f67da1ffe90ee2e00ed6d2eee3ac2a30a694e1fe4484dcb80d63db1",
    "scenes/data/modes/logo_cmyk_deflate.tif":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_greyalpha8.png":
        "ab4446635cd496cfa7a2c79898d822b09c77ef0c63426e1f36201878179ff0bc",
    "scenes/data/modes/logo_interlaced_local.gif":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_lzw_pred2.tif":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_offset87a.gif":
        "4e925c96023fa6014bc64dccff150cb5dcf5eefcc56043fb9741c3edeb3879e6",
    "scenes/data/modes/logo_palette_adam7.png":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_progressive.jpg":
        "6ca72db18beca40ae8d32c3fe2421a339667c534ed778bf6106a07b9db5df803",
    "scenes/data/modes/logo_rgba16_adam7.png":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/logo_rle4.bmp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/modes/texture_2048.jpg":
        "8fe53ffcd38d108910a6da2c19e7b8e85defd7a95fcb9711d8e961c91d2c8024",
}
# SHA-256 of PIL's RGB decode of every file of scenes/data/formats (printed
# by tools/make_image_formats.py; pinned by tests/test_torch_gpu.py too)
FORMAT_DIGESTS = {
    "scenes/data/formats/grid.qoi":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_ascii.ppm":
        "cee47d398d8d24c381acdefa62aff5d47e010e4a55a253500f2c9ce6de337654",
    "scenes/data/formats/grid_bc5_half.dds":
        "e47b86a56cc1f89bc39bee7b6930e179e04774da9f954a078e8a5de5b77ee404",
    "scenes/data/formats/grid_bits.pbm":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats/grid_cmap16_mirrored_rle.tga":
        "798f61bc94ec20227730dac0f42b86a04f2353b70f545b0367dcf54c1b07e245",
    "scenes/data/formats/grid_grey_topdown.tga":
        "973b2927b32f358ee132eee66d6f2433bff570be78cbbaef95998d2ac2892080",
    "scenes/data/formats/grid_group3_2d_fill_lsb_minwhite.tif":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats/grid_planes4.pcx":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_rgb.pcx":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_rle.sgi":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats/grid_ycbcr420_tiles_jpeg.tif":
        "1dc73c34e3f3f96984b3ce545abc78efd68f83d972b671f230bafd49c9a558b7",
    "scenes/data/formats/logo.pfm":
        "8bdfe77adc3ef8b0636ef081b0627110319d08e628d3cb239fa3e8b9c951ef29",
    "scenes/data/formats/logo_bgr15_half.tga":
        "8d36750d3294b929296629048437c870098f8f2c9af5185b41ce876493ea03df",
    "scenes/data/formats/logo_dxt5.dds":
        "e6eb01bd1e8a05a45104aeffb554e32da4f6c1a35a33ed959c749730f8ace3e6",
    "scenes/data/formats/logo_group4.tif":
        "ec2d15d962e2cd0028f779f0fd7acbd77742ad4ee6196eef0f945da94574b402",
    "scenes/data/formats/logo_jpeg.tif":
        "9c0106c01f67da1ffe90ee2e00ed6d2eee3ac2a30a694e1fe4484dcb80d63db1",
    "scenes/data/formats/logo_mh_strips.tif":
        "ec2d15d962e2cd0028f779f0fd7acbd77742ad4ee6196eef0f945da94574b402",
    "scenes/data/formats/logo_palette.dib":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/logo_palette.pcx":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/logo_rgb12.ppm":
        "62c78e652dc843de1ee8a10bffc27ed34425f7febdc7246d1f2ce2942ce2e6b0",
    "scenes/data/formats/logo_rgb_half.dds":
        "9fc2c55bb8bb6e1a2acbb39e637d6c878d1e0517cfdc0d2a7da288aca51095f9",
    "scenes/data/formats/logo_rgba.qoi":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/logo_rgba_half.sgi":
        "9fc2c55bb8bb6e1a2acbb39e637d6c878d1e0517cfdc0d2a7da288aca51095f9",
    "scenes/data/formats/logo_rle.tga":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats/texture_2048_dxt1.dds":
        "992f0a6d348f20ada83c65a356bdc76941940433c0e250fcc29937bb8d6db00e",
}
# SHA-256 of PIL's RGB decode of every file of scenes/data/formats_b
# (printed by `tools/make_image_formats.py formats_b`; pinned by
# tests/test_torch_gpu.py too)
FORMAT_B_DIGESTS = {
    "scenes/data/formats_b/grid.msp":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats_b/grid.xbm":
        "42ca3c9a0b2a8ec3ed6115a060f696ee8be84efa7c3ecb4157e90c9cc060b5e6",
    "scenes/data/formats_b/grid_bc4_ati1.dds":
        "e69093b2cc964a3a14d0533a22a1891b8426805c6fe817a802eebaa1445dc540",
    "scenes/data/formats_b/grid_bc6h_uf16.dds":
        "24816b19d2ec58fa1ec2b138cddd1d97b7149bcfb2c1277044d58c26e967e1d9",
    "scenes/data/formats_b/grid_bmp32.ico":
        "e482778d49d9cdf65d05c2114c91775e119b3216fc817dc14c690dc391e7c1eb",
    "scenes/data/formats_b/grid_dxt1.blp":
        "cc4f280c86efa2aeb94bbd57783c3c2078c19900975e8ebf0fcccf05975e46a3",
    "scenes/data/formats_b/grid_palette.blp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_b/grid_png.icns":
        "e482778d49d9cdf65d05c2114c91775e119b3216fc817dc14c690dc391e7c1eb",
    "scenes/data/formats_b/grid_rgb.im":
        "e482778d49d9cdf65d05c2114c91775e119b3216fc817dc14c690dc391e7c1eb",
    "scenes/data/formats_b/logo.cur":
        "9fc2c55bb8bb6e1a2acbb39e637d6c878d1e0517cfdc0d2a7da288aca51095f9",
    "scenes/data/formats_b/logo_bc4_odd.dds":
        "14a218dd10b398eebe1770b66d185afb0e7f94811b6714cf29f6d7abc12c0fcc",
    "scenes/data/formats_b/logo_bc6h_sf16.dds":
        "419b2b263acbbe191b196d681d57d0bf40fe4de2e048d154025407415f7a7ec4",
    "scenes/data/formats_b/logo_bc7_srgb.dds":
        "e31fa5d65f786ea8b846811fe3eb0242c6c059692b3454a3f6d642546be6e3e9",
    "scenes/data/formats_b/logo_dxt3.blp":
        "b1cf3cbff4b7ea8f4ef718f15c185a445f9039d2e0787eec4ae5e2b650698a47",
    "scenes/data/formats_b/logo_dxt5_odd.blp":
        "c2e61035b3cd6a203462a786889965b2a70a5beaed7340cafa6a8bcdaba335d6",
    "scenes/data/formats_b/logo_f32.im":
        "f61fef78ebe981ba385947fdc0ab941a05b3684e8b63dc3c782fb7dba7ead5b9",
    "scenes/data/formats_b/logo_it32.icns":
        "c25a95c9d9c5ff3c17407a81803655855065f51c2de740ee2887d3fa0a29a4bc",
    "scenes/data/formats_b/logo_jpeg.blp":
        "5a76a7d2fd3c89c1c35d296581cc81371e03b87ed399f2f3f16afca706e802e2",
    "scenes/data/formats_b/logo_palette.blp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_b/logo_palette.im":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_b/logo_png.ico":
        "e0413348d4143c8414c640bc2b475f10e1bf3bd261c5d20026e6d9e1b84b3ed6",
    "scenes/data/formats_b/logo_rle.msp":
        "9279e2093299d64288501876af0686003254afa383d805f7b3ab8f6bbf8bb6da",
    "scenes/data/formats_b/logo_ycc.im":
        "f3c0e0eceb403b11caeddb7aceb9ca7e1b4f752e58f014c1c68be276830e9f1a",
    "scenes/data/formats_b/texture_2048_bc7.dds":
        "4a463dc0bef814d02a20c3ae3f197c55c75cb5b5cd1b0c6ffb5935c12d42fd46",
}
# SHA-256 of PIL's RGB decode of every file of scenes/data/formats_c
# (printed by `tools/make_image_formats.py formats_c`; pinned by
# tests/test_torch_gpu.py too)
FORMAT_C_DIGESTS = {
    "scenes/data/formats_c/crop_12colours_lossless.webp":
        "baf1c4f351aebc09af6065b70635f18f5e2bf5a271b953e1be73f01dba057141",
    "scenes/data/formats_c/crop_17x33.webp":
        "a35c28f0b9e23d207f1dd55356a05baa88dcf4bf8d1ebd8832dab799e670f55d",
    "scenes/data/formats_c/crop_200colours_lossless.webp":
        "a551c82465d61e288863fa7055092bd79e32ac2d705fbbf68874994385199078",
    "scenes/data/formats_c/crop_lossless_m0.webp":
        "d08ee73a38b5a124fc26f93e0557a0491e1bdb3da6f973e10e5b7f88d3be6146",
    "scenes/data/formats_c/crop_lossless_m6.webp":
        "d08ee73a38b5a124fc26f93e0557a0491e1bdb3da6f973e10e5b7f88d3be6146",
    "scenes/data/formats_c/crop_q100.webp":
        "d866221320c4e1069271eb4919696bf88c98d136d39e89071af3a229d517863f",
    "scenes/data/formats_c/grid_big_endian.spider":
        "ef8c72bb8c402cfad35ac5ca20cb502a6073cbcb19d254ba851cf9dff90d382a",
    "scenes/data/formats_c/grid_half.spider":
        "973b2927b32f358ee132eee66d6f2433bff570be78cbbaef95998d2ac2892080",
    "scenes/data/formats_c/grid_icc.webp":
        "3a122d0c539f20895c079307b011c776f74441c40869be273e134d5b450c62fe",
    "scenes/data/formats_c/grid_lossless_m0.webp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_c/grid_lossless_m6.webp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_c/grid_q50.webp":
        "f21d36aa0f12ca7b5229876e661c156077503ce5cf6746a18dbecced4931d297",
    "scenes/data/formats_c/logo_alpha_exif.webp":
        "df219bf266aad832943e276f53c887286e39442b55de9d2e7fff196f7eb60c6d",
    "scenes/data/formats_c/logo_alpha_lossy.webp":
        "59f14f0c0b152c96025fe9d8056221bbc62ec219ba772cfd37a725b4e0eeeec7",
    "scenes/data/formats_c/logo_f32.spider":
        "a1cfff658fb32ef964d5f1851ece5abd0be46a55c7a468446a7f1b76d713adf3",
    "scenes/data/formats_c/logo_odd_q75.webp":
        "0378e1f632c5e63c5c657019bd4606ce03f2af16e83dcc26ace981c8dbc6acd6",
    "scenes/data/formats_c/logo_palette_lossless.webp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_c/logo_q5.webp":
        "25d93a757d6756fd282063337e1aeab445a664f0fd95f754b7a5749bfdd8042e",
    "scenes/data/formats_c/logo_rgba_lossless.webp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_c/logo_rgba_lossless_m0.webp":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_c/logo_stack.spider":
        "4ac3678960dee078bfb14cf91496e955161b4eaf5baa28150975dfb9317b3b44",
    "scenes/data/formats_c/pixel_1x1.webp":
        "723c5189b7cd4addbb16b3ccb29c50596084185751e9a866e00aac09afb463a2",
    "scenes/data/formats_c/texture_2048.webp":
        "84ebb4efeb0844264cb81c14df8982c28b71e24bb5a9786568921221ce0c33c6",
    "scenes/data/formats_c/vp8_partitions8_sharp.webp":
        "2868c421799e583721701a61daed1e4f3527e90f24b36179677d4e507ae5f759",
    "scenes/data/formats_c/vp8_segments_deltas.webp":
        "8cb1c1a071306fb18df04fc06570812a9c18670154af901a829c49cd3b98b256",
    "scenes/data/formats_c/vp8_simple_filter.webp":
        "3fa908da2f001f72d7b2dd1d0ce9e7c078509cc073bf9a71bd1fd8ae26784e74",
    "scenes/data/formats_c/vp8l_all_predictors.webp":
        "ec625d18ddabddeed03b2a415164eb9857b1a43eaf5d9d9e9130c5effe4d65a2",
    "scenes/data/formats_c/vp8l_palette5_past.webp":
        "59122175770d03434c67debbcf7123f957da58924aaa0cd185767da472404a17",
}
FORMAT_D_DIGESTS = {
    "scenes/data/formats_d/crop_cinema2k.j2k":
        "b3def4a753f0baf96ff7cc4be62a815ce2ad2492b764b2eb0ae9b216e2c04d77",
    "scenes/data/formats_d/crop_cinema4k.j2k":
        "b3def4a753f0baf96ff7cc4be62a815ce2ad2492b764b2eb0ae9b216e2c04d77",
    "scenes/data/formats_d/crop_cprl.j2k":
        "3ddcc5ec4c888b7610b1739ebcbf874c67c44525ffdae54e526dedad12a059fc",
    "scenes/data/formats_d/crop_lrcp.j2k":
        "87b7534b86e9bbccf623fc1ed98814e831cd86642329ff59bbb7c5ef27e6a99e",
    "scenes/data/formats_d/crop_palette.jp2":
        "a551c82465d61e288863fa7055092bd79e32ac2d705fbbf68874994385199078",
    "scenes/data/formats_d/crop_pcrl.j2k":
        "d08ee73a38b5a124fc26f93e0557a0491e1bdb3da6f973e10e5b7f88d3be6146",
    "scenes/data/formats_d/crop_rlcp.j2k":
        "a7c653284d0564e7a53bd9e7eab1d92546a0350a66aa1e3ab8dd20f7c12e960c",
    "scenes/data/formats_d/crop_rpcl.jp2":
        "d11978a475ad419d42cf6bf56405f8c81079f6fcc5e8bfbd02f8963892053c10",
    "scenes/data/formats_d/grid_anim_lossless.webp":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_d/grid_jp2.icns":
        "70842a5dae3a8d8f3733e512cb2d0355219a52c90484e9a530c56cc9f557fef1",
    "scenes/data/formats_d/grid_tiles_rpcl.j2k":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_d/logo_anim_lossy.webp":
        "60e6a2131de7be3b407f416f65121c3d088514cc28cd33343776114207075ddb",
    "scenes/data/formats_d/logo_grey16.jp2":
        "f25f028176b10ec7bb91486872f37225e5aeb087daa3f15911c22effcb511dde",
    "scenes/data/formats_d/logo_la.jp2":
        "7425b5387a9549f4e0a940a766156a42b7be62143b0b21e07df28a32ab0f0379",
    "scenes/data/formats_d/logo_rgba_lossless.jp2":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_d/texture_2048.jp2":
        "a014be28b63695fce9d6d732fc537c1567ccfecf68184666ef20e7347154043c",
}
# phase 30: the images put in the textured scene's three MayaFile slots
# (the grid, the logo, the inverted logo)
IMAGE_FRAMES = {
    "A": ("modes/texture_2048.jpg", "modes/logo_lzw_pred2.tif",
          "modes/logo_palette_adam7.png"),
    "B": ("modes/grid.gif", "modes/logo_4bit.bmp", "modes/logo_cmyk.jpg"),
}
# phase 32: the same slots filled from scenes/data/formats
FORMAT_FRAMES = {
    "C": ("formats/texture_2048_dxt1.dds", "formats/logo_rle.tga",
          "formats/logo_jpeg.tif"),
    "D": ("formats/grid.qoi", "formats/logo_palette.pcx",
          "formats/logo_group4.tif"),
}
# phase 34: the same slots filled from scenes/data/formats_b
FORMAT_B_FRAMES = {
    "E": ("formats_b/texture_2048_bc7.dds", "formats_b/logo_bc6h_sf16.dds",
          "formats_b/logo_dxt3.blp"),
    "F": ("formats_b/grid_bmp32.ico", "formats_b/logo_it32.icns",
          "formats_b/logo_palette.im"),
}
# phase 36: the same slots filled from scenes/data/formats_c
FORMAT_C_FRAMES = {
    "G": ("formats_c/texture_2048.webp", "formats_c/logo_rgba_lossless.webp",
          "formats_c/logo_alpha_lossy.webp"),
    "H": ("formats_c/grid_half.spider",
          "formats_c/logo_palette_lossless.webp", "formats_c/logo_q5.webp"),
}
FORMAT_E_DIGESTS = {
    "scenes/data/formats_e/gradient_q5_speed0.avif":
        "a65dfe44180ed4d5158089ca582b9f192dfbf46a187f8a3a0c8c4ff95d1b0c5b",
    "scenes/data/formats_e/grid_lossless_444.avif":
        "9927901a567a92477ea7dbab1bf36de9a766f2dac7f81699245b5224e3801964",
    "scenes/data/formats_e/grid_mirrored.avif":
        "3058ca2c12802b89b74121d47cb77bfd4eed67b0aea3ac6c40fd3fe0ea148a93",
    "scenes/data/formats_e/grid_q50.avif":
        "ad7980f1eb83fd37879d56a2069acfd5a9af12abef273e6f46d8ac1600ce87fb",
    "scenes/data/formats_e/grid_speed0.avif":
        "6a29efe6998ae66201cae83baf00d14f911c67ab12fdf4e83d9b646470fdbb73",
    "scenes/data/formats_e/logo_grey_400.avif":
        "ab4446635cd496cfa7a2c79898d822b09c77ef0c63426e1f36201878179ff0bc",
    "scenes/data/formats_e/logo_icc_exif_xmp.avif":
        "b72cfc58763ceb21e1d1e6b7315349afbb55afd10b340ad38fa073de99ad67ca",
    "scenes/data/formats_e/logo_limited_422.avif":
        "92ccd65b7b5b354b164693712b0d3d5dd6b549e7472fef9574b731a5c0269699",
    "scenes/data/formats_e/logo_premultiplied.avif":
        "8951e7ac20430acf1716b39d8be1395057c9eb658b0b5232eb33370b61f1f207",
    "scenes/data/formats_e/logo_rgba.avif":
        "b72cfc58763ceb21e1d1e6b7315349afbb55afd10b340ad38fa073de99ad67ca",
    "scenes/data/formats_e/odd_17x33.avif":
        "14660b5b38e6d59a3c7cf4c66f28d048f66952e2643e2301db05b5d30543c231",
    "scenes/data/formats_e/odd_17x33_rgba.avif":
        "1b0c27fee17fe01c5e186a9b6fc8eb73912f9d3e58f5c04a1a1671b0c5a6936d",
    "scenes/data/formats_e/photo_420_q0.avif":
        "d1ac0b77e996fe974010a48ce7a45f537cae758150dc4aff975682ca0af9fe95",
    "scenes/data/formats_e/photo_422_q50.avif":
        "2f1dfa7a4004d7b123d4f4c1bff910f48e456d3e83de995eb300e20c16ea7692",
    "scenes/data/formats_e/photo_444_limited.avif":
        "300ada87c0de466103e8c44529b1be69d52de2739ecaed6dd4910bdacf752a4c",
    "scenes/data/formats_e/photo_cdef.avif":
        "aec5a13c3deb61e3a89ac7be969ece00cda50fbd211bf6dfe51fea748301f893",
    "scenes/data/formats_e/photo_deltaq_lf.avif":
        "2554931d1db0c95153fcd417123dcacc8befc4224c976dfcaf2f018ee5635e6c",
    "scenes/data/formats_e/photo_lossless.avif":
        "51e2b527262cea421fb4bb663d45f3de2c0d2296090737792a4c4f1f20ec94fb",
    "scenes/data/formats_e/photo_restoration.avif":
        "3a882b2c72bf1c6b84ecd263f81f4bc45d9673c3bb15cc62b613e24ba7d4eba6",
    "scenes/data/formats_e/photo_speed0.avif":
        "515f89fb1a77c6f1d3d750fd8ab5a7adafa29444c326d58c851808932bab6bd7",
    "scenes/data/formats_e/photo_tiles.avif":
        "b22954c607b3ec2f73025ce383c45f1b6acce61eb747d4c1b79eb7acc24358cc",
    "scenes/data/formats_e/px_1x1.avif":
        "c08134ad48cdadc7fa6e9e810e6588cf28f84b996b45ddc95205986f0372539e",
    "scenes/data/formats_e/texture_2048.avif":
        "210b19f6374af4dd11eca0f429689d9d126e0f832e27e135cb15376fc8e12662",
}
FORMAT_F_DIGESTS = {
    "scenes/data/formats_f/grid_1x2.avif":
        "4cda93acb42cca558449a6fc48354f5f8116ff3135b506cd57ed5aa12abb47ab",
    "scenes/data/formats_f/grid_2x1.avif":
        "33be1b6896c0ba723780ef918bc0fd6906abd772aabbdfd7becffb8f5f18e828",
    "scenes/data/formats_f/grid_2x2_cropped.avif":
        "6886ca3db68212615dd3962a209014a7b372786c312099329f06590376071c8a",
    "scenes/data/formats_f/grid_3x3_odd_444.avif":
        "4e176f242aa7944d1e7ec0ebde359ec14ed2440db9834935bc3a546800da4532",
    "scenes/data/formats_f/grid_rgba.avif":
        "4cda93acb42cca558449a6fc48354f5f8116ff3135b506cd57ed5aa12abb47ab",
    "scenes/data/formats_f/logo_odd_grain_csfl.avif":
        "481ba2dcd2d831403f7ec90cc655ab9c1344f474f13f1b5deecde01bcb20a4cc",
    "scenes/data/formats_f/logo_qm.avif":
        "32508286ffaa50cb15b23ac6f60c9ba5deebf3372e4a0e62ab02b843cd790b7c",
    "scenes/data/formats_f/logo_qm_444_rgba.avif":
        "eee4402423d3b47289070e9175b13d8b8496c7c349ff3d43d269140fd4ed6cb4",
    "scenes/data/formats_f/logo_sequence_rgba.avif":
        "999d40dd536917ae5514b6e157c3edf3aa973eea80463efd9c91e2aeea744616",
    "scenes/data/formats_f/odd_grain_rgba.avif":
        "6b0bd06bf8cc777e93b9eb55e2ef8321e61913bf73c262de83a155563b60381c",
    "scenes/data/formats_f/odd_sequence_444.avif":
        "c749309b8426ef3236c01a449931919acde463ea68e2603fa60277af02ac19ca",
    "scenes/data/formats_f/photo_grain_400.avif":
        "713d8a3993c086cd37bfe70b17ae26b088065ec7d745a8ea77948de936668214",
    "scenes/data/formats_f/photo_grain_422.avif":
        "512e87ac6776b2a52918c0efa21cd9fd830ec0056e476abe1ec7bf17675513f8",
    "scenes/data/formats_f/photo_grain_444.avif":
        "b21119363ded0beeeaef21ec44763b9c04cef1053ab89428a3f3f8d2cd6034ce",
    "scenes/data/formats_f/photo_grain_clip.avif":
        "f36071a2c800bb077cb1b2c68b66517dbec9721fb9fdc926fc057811c3a2c364",
    "scenes/data/formats_f/photo_qm_400.avif":
        "808e69ebf7d9224847e0182314141bc3597b9967ac8c64163edb961aa54c4615",
    "scenes/data/formats_f/photo_qm_420.avif":
        "bcc0ae35ed3733be5684af866a85f0241f66cf943085cd969585948b708cd3bd",
    "scenes/data/formats_f/photo_qm_422.avif":
        "cd7758235b1acb21eb2a745a9d469c34887e2f266b754ee0960a1dada8cb5d3d",
    "scenes/data/formats_f/photo_sequence.avif":
        "0ec148a6755f03fd8bfe2d47bdb6be9fa88d9c1dead0bd3ea140f81961484e53",
    "scenes/data/formats_f/px_1x1_grain.avif":
        "80a028b2c605ce3d66961dd721d658e3bddee02cf044551efcaa22f75114a3b0",
    "scenes/data/formats_f/texture_2048_grain.avif":
        "af4a350fae10b0ce0e1103989a02869359e853e7e0fb4b40be4e77aa7dcf874c",
    "scenes/data/formats_f/texture_2048_grid.avif":
        "3bd3102b7f03bb1098a67c9e9deba700bedf05c81cde670d133137e19d41fb54",
}
FORMAT_G_DIGESTS = {
    "scenes/data/formats_g/grid_scaled_tiles.avif":
        "aab366a351ef92721b655498aea72e4c0bdf824a20fdfaa4629795407d15a8c5",
    "scenes/data/formats_g/grid_ycbcr_2x2_lzw.tif":
        "d551ef075e9db8da02f7b203d0e2bc0938277792a73bb5c2c52c01a0ce8349eb",
    "scenes/data/formats_g/height_1024_float_pred3.tif":
        "8d2bb00f108b8f7d22ae973b3c2d408ec4dccc14c7672fd122468c910b5d12a2",
    "scenes/data/formats_g/logo_int16_signed.tif":
        "8161cec1d4d28cd5584b69f5d196470401b75e179d8d1cc021d40badf91b7c02",
    "scenes/data/formats_g/logo_rgb_rle_layers.psd":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_g/logo_scaled_ispe.avif":
        "9ff7f421a1b5dfc5bf8f2bd4e197b0b91dac60ea501c5c6e3028edecf74617eb",
    "scenes/data/formats_g/logo_sycc.jp2":
        "598a8be5ad1c0024dd367b60c5d948059f52b250962af1ae362b8a7bdd03e825",
    "scenes/data/formats_g/odd_bitmap.psd":
        "14d9ce0209c20f421ac95252bfa82a19493c67f61d95eb6f05f06fdf5531f73c",
    "scenes/data/formats_g/odd_cmyk5_raw.psd":
        "91df149e0c473e662d4d55b679033daed272b34fa3b28f50257621e7efc104b8",
    "scenes/data/formats_g/odd_duotone_layers.psd":
        "8546f1639dffc80b91862f4d9bace0a575b117562b3dbfaf73be2e4a15d3a4cd",
    "scenes/data/formats_g/odd_float_minwhite_raw.tif":
        "33bf392a5b5dd619c7835bb8f57a80fd77ef3d846150815b36e3580f0879bf84",
    "scenes/data/formats_g/odd_float_mm_raw_planar.tif":
        "e316916794f52b41ef97892d95b40e999ffb212cb3e6f17bfadb45aa57eae4aa",
    "scenes/data/formats_g/odd_float_mm_tiles_lzw_pred3.tif":
        "07fb8807f0c98238845551898d3113fb0786f7dcdaef0e9a1edf45af34c0e63a",
    "scenes/data/formats_g/odd_grey_rle.psd":
        "8546f1639dffc80b91862f4d9bace0a575b117562b3dbfaf73be2e4a15d3a4cd",
    "scenes/data/formats_g/odd_indexed.psd":
        "7f0b7a2904c517ec3fe186dca51472c4f065629eb93029d5562c7391772a5f7d",
    "scenes/data/formats_g/odd_int16_signed_mm_deflate.tif":
        "c84f3f9d6a421abd122970b36ecb29c8f3306260c925cd287bbf7221c7b9862c",
    "scenes/data/formats_g/odd_int32_signed_packbits.tif":
        "c84f3f9d6a421abd122970b36ecb29c8f3306260c925cd287bbf7221c7b9862c",
    "scenes/data/formats_g/odd_int8_signed.tif":
        "a04e12bfd70c23c93e91f039e491839c94a565239f2a6921c8eca5b353090526",
    "scenes/data/formats_g/odd_multichannel_spill.psd":
        "1ee8cdc9f87f385cc4467d674913cc34869974457614b40a4bcd7131f36325f9",
    "scenes/data/formats_g/odd_rgba_rle.psd":
        "91df149e0c473e662d4d55b679033daed272b34fa3b28f50257621e7efc104b8",
    "scenes/data/formats_g/odd_scaled_420_rgba.avif":
        "a81079dd57df00f51f8b0a55092c155404adc20ae9d3fbb0485928f5237a1d8f",
    "scenes/data/formats_g/odd_sycc.j2k":
        "ab2c2a95386ae01011b06473d336cd4415a4aff0082033d515db4cf41c291f1c",
    "scenes/data/formats_g/odd_sycc_rgba.jp2":
        "0eb666ce778530f995de5f80bac1f3043d6d9f11561bd62d29843b8acb6d5ee7",
    "scenes/data/formats_g/odd_uint32_lzw_pred2.tif":
        "29a5ed34335c82d05e7169d18fdce8150a7706bc04d2163c0bb45c5010fba81a",
    "scenes/data/formats_g/odd_ycbcr_1x2_lzw.tif":
        "9e807dff915dc27f6999e0bc5448a7cb5260b6f0e45f20d683bfcbe51370daa3",
    "scenes/data/formats_g/odd_ycbcr_2x1_mm_pred2.tif":
        "06e2aea1dc4bb6a181f318be2352fa105a4eef299afb279deac47fc9c184cf6e",
    "scenes/data/formats_g/odd_ycbcr_4x2_bt709_studio.tif":
        "e7bacaa80d514f9d4efe2dfcddd17a24ec789c2cdf18618f6a2fb38f24dbdcf6",
    "scenes/data/formats_g/odd_ycbcr_4x4_tiles_deflate.tif":
        "3c03327176f922d0903eaf36317b0f6eaf632a18276c33bb2c1adf33374defd6",
    "scenes/data/formats_g/odd_ycbcr_default_2x2.tif":
        "722b056613ad38649b91f3a1bced3bbab452b56f354a85c729c69574f2ada5de",
    "scenes/data/formats_g/odd_ycbcr_pil_packbits.tif":
        "e2fc7f66a916af36f43b7879508e4c6f016dcccee4b889a6d548cc655b75c700",
    "scenes/data/formats_g/photo_cmyk_rle.psd":
        "69194ec3da9e830ffd79b8408548fab7d16514f2b7011a6c7a350de4ca600e1f",
    "scenes/data/formats_g/photo_scaled_down34.avif":
        "25e567d1d4cb61844b066097b9a8b26c4af67a68b6395e13c758e1e929ee8af9",
    "scenes/data/formats_g/sequence_scaled.avif":
        "afe4db386d3d87a113f44b25ee1a5579e657f08a9d8d6c74d662f7a123ffd234",
}
FORMAT_H_DIGESTS = {
    "scenes/data/formats_h/grid.xpm":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_h/logo_dxt1.ftex":
        "e6eb01bd1e8a05a45104aeffb554e32da4f6c1a35a33ed959c749730f8ace3e6",
    "scenes/data/formats_h/logo_lab_rle.psd":
        "aaa8db6a2eed862bbb8dc071d151a515823ab55bc6384117393d0a846a6c6952",
    "scenes/data/formats_h/logo_rle24.ras":
        "7322e30e8b5558d0a1655b7c69cb56d546f937220d9917a481d754487840b184",
    "scenes/data/formats_h/odd.imt":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd.pixar":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd.xvthumb":
        "a1df4c45ac91c67b62679b56b1c821faceffeedfc0fad8177f3e5e2e985fd5ef",
    "scenes/data/formats_h/odd_16bit.mcidas":
        "d19978fd6926d907ca658b97337520209ae9c8e9c4b14c934c363d68f85f4e3c",
    "scenes/data/formats_h/odd_32bit.mcidas":
        "8bea24d20ef5c1bc042888885a1c9a744d3e5141ab33d47cc9ec2c038d51030b",
    "scenes/data/formats_h/odd_8bit.mcidas":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd_bgr32_rle.ras":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_bilevel.ras":
        "12297ef5b93f14b082049f303c8a2a697a538e29e569b532217656f11e4588cb",
    "scenes/data/formats_h/odd_bilevel_rle.ras":
        "04873d81115c2e1b9f877dda673e1a321dbb4442e0aa39b0f2996291e0621cdc",
    "scenes/data/formats_h/odd_grey4.ras":
        "414afd8a17fa6095c8f324b5a35c41b0b722b051329012bbd292f106590e2430",
    "scenes/data/formats_h/odd_grey4_pal.ras":
        "a1f8f5ceb8da9308bad11c92d2a1ec42c2ebdb03ffe6ebd2b638e6843cb63f58",
    "scenes/data/formats_h/odd_grey8.ras":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd_grey8_pal_rle.ras":
        "d07856adc5c2cd374efccdb74f80d1e815c2ebf135bbd94e273a0f1bfdd1c62f",
    "scenes/data/formats_h/odd_lab_jpeg.tif":
        "67df6576ca494df6ae1cfd0f3e0eed89f6ce0fb16bf62298e4ed1599f47adb23",
    "scenes/data/formats_h/odd_lab_lzw_mm.tif":
        "3338ed9e4f69d95a2c3d8d3f771846ebb2474413b0267b0c4204a1e7ca3e04ac",
    "scenes/data/formats_h/odd_lab_packbits_tiles.tif":
        "3338ed9e4f69d95a2c3d8d3f771846ebb2474413b0267b0c4204a1e7ca3e04ac",
    "scenes/data/formats_h/odd_lab_raw.psd":
        "3338ed9e4f69d95a2c3d8d3f771846ebb2474413b0267b0c4204a1e7ca3e04ac",
    "scenes/data/formats_h/odd_many_2chars.xpm":
        "42b01fa8b5b81ce66b1befd56ee50158dc3c62d1967a0b38d28024d9aae62439",
    "scenes/data/formats_h/odd_pages.dcx":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_rgb.ftex":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_rgb32_rgb_order.ras":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_v1_grey.gbr":
        "bb97b8e787ef025674c8f898b54f19ff31c020f8c1ae04e3a0440b26614dff31",
    "scenes/data/formats_h/odd_v2_rgba.gbr":
        "ca580c6278eab3890c7528c168dcc6c5614a956ee200d3f82a7c2e5197f2a64b",
    "scenes/data/formats_h/odd_zstd_grey16_size.tif":
        "8bea24d20ef5c1bc042888885a1c9a744d3e5141ab33d47cc9ec2c038d51030b",
    "scenes/data/formats_h/odd_zstd_mm_float_pred3.tif":
        "a70e25e811d699bbc050a13853fb21fbb15798d252b7bb052949ee18871d0d4b",
    "scenes/data/formats_h/photo_512_zstd_tiles_pred2.tif":
        "5f1e5247503101cd046b8df73ec3b287f37690d74cca35571c217e606591540e",
    "scenes/data/formats_h/texture_1024_lab_zstd.tif":
        "a224c154faad8a39f9105048b7409be3ce930931017a5ea11f53a65dc77990c5",
}
# phase 41: the header-only files past PIL's decompression-bomb limit
FORMAT_I_DIGESTS = {
    "scenes/data/formats_i/grey_restart_resync.jpg":
        "9efbe8668ffa17180c95ce1804c2ecb155dbed6e7530200c196e762d0c415e88",
    "scenes/data/formats_i/grid_bad_code.jpg":
        "271c40617cd9861173998400b8b84ee786bd275b2bdd557eaa77726d33cc197e",
    "scenes/data/formats_i/grid_brun.flc":
        "a14b0a190c4f0a3d51fea9a8f5e1379538f6e10f6425e04a8c03adda09b084d8",
    "scenes/data/formats_i/grid_eoi_lost.jpg":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/formats_i/grid_jpeg_rgb.iptc":
        "95c6e193d2be4e9f04f28f29048cfc0acf2ac85fc03479fa7c978f919caa9603",
    "scenes/data/formats_i/grid_marker_hit.jpg":
        "e90d480e11be770ebd5fa27b69749b504c5120d033bf49538e80f65e28dedf95",
    "scenes/data/formats_i/grid_simd_idct.jpg":
        "bfdba60e64efd2c7f5faab18da669686aae317d18926f3502d6f3dd88aa0d5d3",
    "scenes/data/formats_i/height_512_16bit_gzip.fits":
        "b1928e3847cee529bc77fbec4d212096d9028942dc10871e2ebea9ab4b114557",
    "scenes/data/formats_i/idct_extremes.jpg":
        "8fa941d8d953e73101a28026ad4b6931f9153452a6526101b6ef62fbf9bb1eac",
    "scenes/data/formats_i/logo_color64_lc.fli":
        "9235ce5548639131ac5263a311c9dbe788c51fc212c274ebf86365af314d5d2e",
    "scenes/data/formats_i/logo_progressive_damaged.jpg":
        "d0c63af717edb1452e204262ae2b269ae12b28be3f586ae53700f8057fab93ef",
    "scenes/data/formats_i/logo_progressive_refine_damaged.jpg":
        "f9f7fdbb609ab7250d937707b7a84177e0feb4f3816e25bb5718b7e311fed600",
    "scenes/data/formats_i/logo_progressive_smoothed.jpg":
        "0c8b53f71072fd528afd6388b87170923925747eb9610810d304908e5c6a2ec2",
    "scenes/data/formats_i/logo_raw_rgb_band.iptc":
        "a48a51cfb18fb128bac5abcae1c3cec84171ddf1db242099c1c8d9062eb5fe03",
    "scenes/data/formats_i/odd_16bit.fits":
        "b893342bd21033ebd2982643f04756d8be6f19547f2aacdd222b54244df77fbe",
    "scenes/data/formats_i/odd_32bit.fits":
        "a11dc20a06020aa1e412cfda48637db9efa22a6bfdf36fd81d8e41838b733ac7",
    "scenes/data/formats_i/odd_8bit.fits":
        "263a356d19ff7d7804b61a25b5bdc5435b50a0ec4fe8b04a9a26a2feafeb547b",
    "scenes/data/formats_i/odd_copy_ss2.flc":
        "f0ee3cebc30e3928bc2bc52b335a0914845144a03024b832c13bcc97a3f2b516",
    "scenes/data/formats_i/odd_float32.fits":
        "ef7ea9e7d344b663215acb5e12a85f99243cf09b2bbb6616e5968111b623508e",
    "scenes/data/formats_i/odd_float64.fits":
        "1f1880d3314bb461c938b0a2cbad86082fc5feef741794749c450b4a1f5e68fc",
    "scenes/data/formats_i/odd_gzip_tiles.fits":
        "45ae504ffcff808acc26af288699f1ad4e4f3e3adbf9db052f1d7e85b27f3065",
    "scenes/data/formats_i/odd_jpeg_grey.iptc":
        "acd0ef9d34a327a5979eee7e7db3f6b3b4c4b56c807f3f1ac2bd76e8fb7e9243",
    "scenes/data/formats_i/odd_lab_jpeg_damaged.tif":
        "b09b55ea3ee94fb5214e56c49fa5a57b9176480a11404468fc9fb6329ae9fd8d",
    "scenes/data/formats_i/odd_naxis1.fits":
        "ccf503c4464a74530639b1bdfd14ebb9561e2d1e5314429a87fce9e574a5656f",
    "scenes/data/formats_i/odd_naxis3.fits":
        "263a356d19ff7d7804b61a25b5bdc5435b50a0ec4fe8b04a9a26a2feafeb547b",
    "scenes/data/formats_i/odd_raw_cmyk_band.iptc":
        "3404e61a251e9bddb20bd9c875a24d522f0a1cd8b6e03ccdbd1c1312d766d2f1",
    "scenes/data/formats_i/odd_raw_grey.iptc":
        "263a356d19ff7d7804b61a25b5bdc5435b50a0ec4fe8b04a9a26a2feafeb547b",
    "scenes/data/formats_i/photo_768.pcd":
        "e56fd6ea8f88312ed29f9267c12541bdc699184cdf28571afc2453a4b6b21bbd",
    "scenes/data/formats_i/photo_768_turn270.pcd":
        "a9171b99c0b982b0f2bdcc0d4b867316022b4d52f7d945ce0c9baa98b0d8cd2d",
    "scenes/data/formats_i/photo_768_turn90.pcd":
        "cf9fdc7d9b858fba9c7bf99a076662bc79b6c9013eb6a9eb737c02f4528a425c",
    "scenes/data/formats_i/texture_640_brun.flc":
        "94c5cb97c0388e22a49a0be2f9debbdcaf9e2376b4fd2526b7540c19d8fcf420",
}
BOMBS = "scenes/bombs"
BOMB_FILES = ("avif.bomb", "blp.bomb", "bmp.bomb", "cur.bomb", "dds.bomb",
              "dib.bomb", "gif.bomb", "icns.bomb", "ico.bomb", "im.bomb",
              "jpeg.bomb", "jpeg2000.bomb", "msp.bomb", "pcx.bomb",
              "png.bomb", "png_whole.bomb", "ppm.bomb", "qoi.bomb",
              "sgi.bomb", "spider.bomb", "tga.bomb", "tiff.bomb",
              "webp.bomb", "xbm.bomb")
# phase 38: the same slots filled from scenes/data/formats_d
FORMAT_D_FRAMES = {
    "I": ("formats_d/texture_2048.jp2", "formats_d/logo_rgba_lossless.jp2",
          "formats_d/logo_anim_lossy.webp"),
    "J": ("formats_d/crop_palette.jp2", "formats_d/grid_tiles_rpcl.j2k",
          "formats_d/grid_anim_lossless.webp"),
}
# phase 40: the same slots filled from scenes/data/formats_e
FORMAT_E_FRAMES = {
    "K": ("formats_e/texture_2048.avif", "formats_e/logo_rgba.avif",
          "formats_e/logo_premultiplied.avif"),
    "L": ("formats_e/grid_lossless_444.avif", "formats_e/logo_grey_400.avif",
          "formats_e/logo_limited_422.avif"),
}
# phase 42: the same slots filled from scenes/data/formats_f
FORMAT_F_FRAMES = {
    "M": ("formats_f/texture_2048_grain.avif",
          "formats_f/logo_sequence_rgba.avif", "formats_f/logo_qm.avif"),
    "N": ("formats_f/texture_2048_grid.avif",
          "formats_f/logo_qm_444_rgba.avif",
          "formats_f/logo_odd_grain_csfl.avif"),
}
# phase 44: the same slots filled from scenes/data/formats_g (three slots:
# the CMYK PSD of the sweep is decoded in phase 43 only)
FORMAT_G_FRAMES = {
    "O": ("formats_g/height_1024_float_pred3.tif",
          "formats_g/logo_int16_signed.tif",
          "formats_g/logo_rgb_rle_layers.psd"),
    "P": ("formats_g/grid_ycbcr_2x2_lzw.tif", "formats_g/logo_sycc.jp2",
          "formats_g/logo_scaled_ispe.avif"),
}
# phase 46: the same slots filled from scenes/data/formats_h
FORMAT_H_FRAMES = {
    "Q": ("formats_h/texture_1024_lab_zstd.tif",
          "formats_h/photo_512_zstd_tiles_pred2.tif",
          "formats_h/logo_rle24.ras"),
    "R": ("formats_h/logo_lab_rle.psd", "formats_h/grid.xpm",
          "formats_h/logo_dxt1.ftex"),
}
# phase 48: the same slots filled from scenes/data/formats_i
FORMAT_I_FRAMES = {
    "S": ("formats_i/texture_640_brun.flc", "formats_i/photo_768.pcd",
          "formats_i/logo_progressive_smoothed.jpg"),
    "T": ("formats_i/height_512_16bit_gzip.fits",
          "formats_i/logo_raw_rgb_band.iptc",
          "formats_i/grid_simd_idct.jpg"),
}
# phase 45's file whose ZSTD and LAB shares are printed apart
FORMAT_H_SPLIT = "scenes/data/formats_h/texture_1024_lab_zstd.tif"
# width and height of frames E to T held to the walk (a check's time
# follows its launches, not its size, so compare() walks each kernel's
# queries of a frame at once), and of frames A to T on the card and the
# CPU (24 until the script neared its time limit; all their planes agreed
# in every pixel)
FORMAT_B_CHECK = 24
IMAGE_CPU = 16
FORMAT_PHASES_S = 60.0  # phases 31-32 together, and phases 33-34
# phases 35-36 together: the lossy WebP's boolean decoder is Python
FORMAT_C_PHASES_S = 90.0
# phases 37-38 together: the 2048x2048 JP2's wavelet runs in numpy
FORMAT_D_PHASES_S = 90.0
# phases 39-40 together: the AV1 tiles decode in native code
FORMAT_E_PHASES_S = 60.0
# phases 41-42 together, the bomb files included
FORMAT_F_PHASES_S = 60.0
# phases 43-44 together: the YCbCr TIFF and PSD decoders are numpy
FORMAT_G_PHASES_S = 60.0
# phases 45-46 together: LAB is numpy over each distinct colour, ZSTD
# native code
FORMAT_H_PHASES_S = 60.0
# phases 47-48 together: FLI, PhotoCD, FITS and IPTC are numpy, the
# damaged JPEGs' Huffman decode Python
FORMAT_I_PHASES_S = 60.0
# each frame's launches at the scene's own options (phase 25's)
IMAGE_LAUNCHES = {"rls_nearest": 16, "rls_occluded": 60}
# the dense Disney scene (phases 26-28): quads round each ball, and the
# copy on which the plain builder is held to the native one
DENSE_AROUND = 512
DENSE_SMALL = 64
DENSE_AA = 3
DENSE_CHECK = 64    # width and height of the dense frame held to the walk
DENSE_CPU = 16      # width and height of the dense CUDA vs CPU frames, AA 1
SOUP = 12000       # triangles: tables too large for shared memory
REPLACES = {
    "rls_nearest": "rlshaders_tpu/ops/intersect_pallas.py:342",
    "rls_occluded": "rlshaders_tpu/ops/intersect_pallas.py:455",
}
SOURCE = "rlshaders_tpu_torch/ops/csrc/intersect.cu"
# CUDA vs CPU frame (phase 5): float32 arithmetic differs between the
# devices (CUDA divides by a scalar through its reciprocal, transcendental
# functions differ in the last bits, the splat sums in atomic order), so a
# few samples take another branch at triangle edges and horizons. Nearly
# all pixels agree closely and the frame means agree.
PIX_TOL = 1e-3        # abs, per channel
PIX_FRAC = 0.98       # share of pixels within PIX_TOL
MEAN_RTOL = 2e-3      # frame mean, relative

# The bound of a kernel (the least time the card could take for the work):
# the larger of the bytes it must move over the H100's HBM rate and its
# float operations over the H100's float32 rate outside the tensor cores.
# Bytes: each output written once (nearest: t, tri, u, v, 16 B; occluded:
# 1 B); each live ray's o, d, t_max and exclude (32 B) read once, but only
# the 4 B of t_max of a dead lane (t_max <= 0), since the kernels read the
# rest inside `if (tm > 0)`; and each tree node and triangle slot that
# the walk tests read once (the plain walk marks them, accel/bvh.py
# `counts`: what these rays need, not the whole tables, which on the
# global path a launch never reads whole).
# The live count is the plain walk's (`counts["rays"]`). Operations: the
# slab tests and triangle
# tests the plain walk makes for these rays (accel/bvh.py `counts`), times
# the float operations of each in ops/csrc/intersect.cu, counting every
# add, multiply, min, max, abs, compare and reciprocal as one.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_RAY = 9       # inv_dir: abs, compare, reciprocal per axis
OPS_PER_BOX = 25      # box_hit: 6 sub, 6 mul, 11 min/max, 2 compares
OPS_PER_TRI = 53      # tri_test: Moller-Trumbore and its 6 hit compares
OUT_BYTES = {"rls_nearest": 16, "rls_occluded": 1}

# The random draws' kernels (ops/csrc/rng.cu, phase 49). They replace no
# TPU kernel: the JAX package leaves its draws to XLA.
RNG_KERNELS = {
    "rls_rng_threefry": "none: rlshaders_tpu/core/rng.py's jax.random "
                        "threefry draws, left to XLA",
    "rls_rng_sobol_stream": "none: rlshaders_tpu/core/rng.py's Owen-Sobol "
                            "streams in jnp, left to XLA",
    "rls_rng_sobol_at": "none: rlshaders_tpu/core/rng.py's Owen-Sobol "
                        "points in jnp, left to XLA",
}
RNG_SOURCE = "rlshaders_tpu_torch/ops/csrc/rng.cu"
# phase 49 draws at the shapes of one tile of portbench's disney.frame512
# cell (the disney_grid scene at 512x512, AA 3: one tile of 262,144
# pixels) and renders that frame
RNG_SCENE = "portbench/configs/disney_grid.ass"
RNG_RES = 512
RNG_AA = 3
RNG_LANES = RNG_RES * RNG_RES * RNG_AA * RNG_AA   # 2,359,296
RNG_SEED = 2**31 + 5   # above 32 signed bits, as the benchmark's seeds
RNG_SALT = 0xFFFFFFFF
RNG_PURPOSE = 604 << 8
RNG_COLUMNS = 4        # purposes a lane of the SSS stage's light columns
RNG_S = 4              # the tile's sobol2_flat s_count and uniform2 columns
#                        (the grid's 2x2 light and BSDF samples)
RNG_REPS = 20
# The tile's draws, as the frame512 frame makes them (phase 49 reads the
# frame's launches per kernel and holds them to this mix): name -> calls
RNG_TILE = {"camera_uniform": 1, "uniform2": 11, "stratified2_flat": 1,
            "sobol2_flat": 3}
# Operations of one output element (a value of a threefry draw, a row of
# two of a Sobol draw), counted from ops/csrc/rng.cuh and rng.cu as
# written: each add, xor, and, or, shift, rotate (one funnel shift), bit
# reversal (one __brev), multiply, compare, select, conversion and float
# add, multiply or division counts one; an int64 division or remainder
# counts one though the card emulates it in tens of instructions, and
# nothing the compiler folds into a constant is counted, so the count is a
# floor. Over ISSUE_OPS_PER_S, the H100's issue rate (four warp
# instructions a clock an SM: 128 lanes x 132 SMs x 1.98 GHz): Hopper also
# issues integer adds, logic and multiplies on its float pipe, so the
# 64-lane int32 pipe alone is no bound (a tile's draws run faster than it
# would allow).
ISSUE_OPS_PER_S = 128 * 132 * 1.98e9
OPS_INDEX = 3          # the thread's element index and its bounds test
OPS_THREEFRY = 80      # third key word 2, first injection 2, 20 rounds x
#                        (add, rotate, xor) 60, four more injections x 3
#                        and the last 3, the xor of the two words 1
OPS_UNIT = 5           # unit_float: shift, or, subtract, compare, select
OPS_STRAT = {"batch": 11, "flat": 10}   # the stratum (mode test, shift or
#                        multiply, division or remainder, the plane bit),
#                        then two conversions, an add and a division
OPS_SOBOL2 = 94        # two lowbias32 (16) and the seed's xor, two Owen
#                        scrambles (2 x 11), the index's bit reversal,
#                        sobol_d1 (16 bits x shift, and, select-xor),
#                        two to_unit (2 x 3)
RNG_OPS = {
    "bits": OPS_INDEX + 1 + OPS_THREEFRY,
    "uniform": OPS_INDEX + 2 + OPS_THREEFRY + OPS_UNIT,
    "stratified2": OPS_INDEX + 2 + OPS_THREEFRY + OPS_UNIT
    + OPS_STRAT["batch"],
    "stratified2_flat": OPS_INDEX + 2 + OPS_THREEFRY + OPS_UNIT
    + OPS_STRAT["flat"],
    # the row's lane and sample (layout tests, division, remainder), its
    # index (multiply, add), the stream's seed (xor, lowbias32)
    "sobol_stream": OPS_INDEX + 15 + OPS_SOBOL2,
    # the lane (division), the seeded and purposes tests; the stream's
    # seed: xor, lowbias32, and for a purpose column its remainder,
    # lowbias32 and xor
    "sobol_at_seeded": OPS_INDEX + 2 + OPS_SOBOL2,
    "sobol_at": OPS_INDEX + 3 + 9 + OPS_SOBOL2,
    "sobol_at_columns": OPS_INDEX + 3 + 19 + OPS_SOBOL2,
}


# The lobes' kernels (ops/csrc/bsdf.cu, phase 50). They replace no TPU
# kernel: the JAX package leaves its lobes to XLA.
LOBE_ENTRIES = ("eval_diffuse", "sample_diffuse", "eval_specular",
                "sample_specular", "sample_refract")
LOBE_KERNELS = {f"rls_bsdf_{e}": "none: the lobes of rlshaders_tpu/models/"
                "dispatch.py in jnp, left to XLA" for e in LOBE_ENTRIES}
LOBE_SOURCE = "rlshaders_tpu_torch/ops/csrc/bsdf.cu"
# phase 50 holds every lobe call of the frame512 frame (RNG_SCENE, one
# tile) and of the glass cell's first refraction family to the eager code
LOBE_GLASS = "portbench/configs/glass_sphere.ass"
LOBE_FAMILY = 4 * RNG_LANES   # 9,437,184: a frame512 column or family
LOBE_REPS = 10
# the share of an entry's lanes that may be far from the eager lobes (a
# gate flipped on a last bit of libdevice's transcendentals, which the
# kernels reach built with -fmad=false)
LOBE_FAR_SHARE = 0.002
# Bytes a lane reads and writes in bsdf.cuh, by the branch it takes
# ("disney", "skin" or "other"): its directions or random numbers, the
# fields its model reads (4 B, a mask 1 B) and its output rows; "mtype"
# where the table's rlDisney or rlSkin parts make the lane read its type.
LOBE_BYTES = {
    "eval_diffuse": {"lane": 24 + 1 + 16, "mtype": 4,
                     "disney": 24, "skin": 16, "other": 16},
    "sample_diffuse": {"lane": 8 + 12, "mtype": 0,
                       "disney": 0, "skin": 0, "other": 0},
    "eval_specular": {"lane": 24 + 1 + 16, "mtype": 4,
                      "disney": 48, "skin": 80, "other": 44},
    "sample_specular": {"lane": 20 + 12, "mtype": 4,
                        "disney": 16, "skin": 32, "other": 12},
    "sample_refract": {"lane": 20 + 1 + 24, "mtype": 0,
                       "disney": 32, "skin": 32, "other": 32},
}
# Operations a lane of each branch, estimated from bsdf.cuh as written:
# each float add, multiply, division, square root, compare, select,
# minimum or maximum counts one, and so does each libdevice call (expf,
# logf, sinf, cosf, tanf, acosf), which runs tens: a floor.
LOBE_OPS = {
    "eval_diffuse": {"disney": 80, "skin": 85, "other": 85},
    "sample_diffuse": {"disney": 25, "skin": 25, "other": 25},
    "eval_specular": {"disney": 220, "skin": 330, "other": 190},
    "sample_specular": {"disney": 110, "skin": 115, "other": 105},
    "sample_refract": {"disney": 180, "skin": 180, "other": 180},
}

def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (after one warm call)."""
    fn()
    return events_ms(fn, reps)


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, CUDA events, no warm
    call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(run, reps: int) -> float:
    """Device milliseconds of one call of `run` (a pass of kernel
    launches): the pass captured in one CUDA graph, its replays timed with
    CUDA events, so the launches' host time is paid once, at capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def device_events(prof) -> dict:
    """The card's activity in a torch.profiler run, by name: [device ms,
    count]. Read from the raw events, as cli.py reads them: turning a
    frame's events into FunctionEvents (`key_averages()`) takes tens of
    seconds for one glass tile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = out.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return out


def profiled_ms(run, key: str) -> float:
    """torch.profiler's device milliseconds of the kernels whose name holds
    `key`, over one eager call of `run`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(ms for name, (ms, _) in device_events(prof).items()
               if key in name)


def capture_queries(scene, accel, wavefront, tracemod, **render_kw):
    """Render one frame on the card, recording the inputs of every ray
    query it makes."""
    calls = []
    real_nearest, real_occluded = tracemod.nearest, tracemod.occluded

    def nearest(acc, o, d, vis_mask, exclude_tri=None, t_eps=1e-4,
                t_max=None):
        r = o.shape[0]
        tm = (torch.full((r,), 1e30, device=o.device) if t_max is None
              else t_max)
        ex = (torch.full((r,), -1, dtype=torch.int32, device=o.device)
              if exclude_tri is None else exclude_tri.to(torch.int32))
        calls.append(("rls_nearest", o.clone(), d.clone(), tm.clone(),
                      ex.clone(), vis_mask))
        return real_nearest(acc, o, d, vis_mask, exclude_tri, t_eps, t_max)

    def occluded(acc, o, d, t_max, vis_mask, exclude_tri=None, t_eps=1e-4):
        r = o.shape[0]
        ex = (torch.full((r,), -1, dtype=torch.int32, device=o.device)
              if exclude_tri is None else exclude_tri.to(torch.int32))
        calls.append(("rls_occluded", o.clone(), d.clone(), t_max.clone(),
                      ex.clone(), vis_mask))
        return real_occluded(acc, o, d, t_max, vis_mask, exclude_tri, t_eps)

    tracemod.nearest, tracemod.occluded = nearest, occluded
    try:
        wavefront.render(scene, accel, seed=SEED, **render_kw)
    finally:
        tracemod.nearest, tracemod.occluded = real_nearest, real_occluded
    return calls


def random_queries(accel, n: int, seed: int):
    """Random rays through the scene's bounds: a tenth dead (t_max <= 0),
    a third excluding a random triangle, and each visibility bit."""
    rng = np.random.default_rng(seed)
    lo = accel.tree.bbox_min[0].cpu().numpy()
    hi = accel.tree.bbox_max[0].cpu().numpy()
    span = hi - lo
    o = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a few axis-aligned directions with signed zeros
    d[:64] = 0.0
    d[:64, 1] = -1.0
    d[:32, 0] = -0.0
    t_max = rng.uniform(0.5, 20.0, n)
    t_max[rng.random(n) < 0.1] = rng.choice([0.0, -1.0])
    t_max[rng.random(n) < 0.3] = 1e30
    n_tri = accel.tree.tri_order.shape[0]
    ex = np.where(rng.random(n) < 0.3, rng.integers(0, n_tri, n), -1)
    tens = (torch.tensor(o, dtype=torch.float32, device=DEVICE),
            torch.tensor(d, dtype=torch.float32, device=DEVICE),
            torch.tensor(t_max, dtype=torch.float32, device=DEVICE),
            torch.tensor(ex, dtype=torch.int32, device=DEVICE))
    out = []
    for bit in range(8):
        for name in ("rls_nearest", "rls_occluded"):
            out.append((name, *tens, 1 << bit))
    return out


def soup_accel(tracemod, t: int, seed: int = 8):
    """A random soup of t small triangles on the card, random visibility
    bits and opacity."""
    rs = np.random.default_rng(seed)
    geom = types.SimpleNamespace(
        v0=rs.uniform(-1, 1, (t, 3)), e1=rs.uniform(-0.05, 0.05, (t, 3)),
        e2=rs.uniform(-0.05, 0.05, (t, 3)),
        visibility=rs.integers(1, 256, t), opaque=rs.random(t) < 0.7)
    dtypes = {"visibility": torch.int32, "opaque": torch.bool}
    return tracemod.build(types.SimpleNamespace(**{
        k: torch.tensor(v, dtype=dtypes.get(k, torch.float32), device=DEVICE)
        for k, v in vars(geom).items()}))


def compare(accel, calls, bvh, kernels):
    """Run kernel and plain version on the captured queries; returns per
    kernel [mismatching rays, rays, max abs error, the plain walk's work
    counts]. The kernel runs each captured launch as the frame made it;
    the plain walk runs once over all of a kernel's queries that share a
    visibility mask (a ray's walk depends on that ray alone, and a walk's
    time on its lockstep steps, not its rays), so its "steps" count is
    the sum of those walks' longest. The walk counts its work here, so
    it is not timed here."""
    res = {k: [0, 0, 0.0, {}] for k in REPLACES}
    groups = {}
    for name, o, d, tm, ex, vis in calls:
        groups.setdefault((name, vis), []).append((o, d, tm, ex))
    for (name, vis), queries in groups.items():
        counts = res[name][3]
        o, d, tm, ex = (torch.cat(x) for x in zip(*queries))
        if name == "rls_nearest":
            got = [kernels.nearest(accel.packed, *q, vis) for q in queries]
            hk = type(got[0])(*(torch.cat(f) for f in zip(*got)))
            hp = bvh.intersect(accel.tree, accel.tris, o, d, tm, ex, vis,
                               counts=counts)
            bad = ((hk.tri != hp.tri) | (hk.t != hp.t) | (hk.u != hp.u)
                   | (hk.v != hp.v))
            hit = hp.tri >= 0
            err = max(float((hk.t - hp.t)[hit].abs().max()) if hit.any()
                      else 0.0,
                      float((hk.u - hp.u).abs().max()),
                      float((hk.v - hp.v).abs().max()))
        else:
            bk = torch.cat([kernels.occluded(accel.packed, *q, vis)
                            for q in queries])
            bad = bk != bvh.occluded(accel.tree, accel.tris, o, d, tm, ex,
                                     vis, counts=counts)
            err = float(bad.any())
        r = res[name]
        r[0] += int(bad.sum())
        r[1] += o.shape[0]
        r[2] = max(r[2], err)
    return res


def table_bytes(accel) -> int:
    p = accel.packed
    return p.nodes.numel() * 4 + p.tris.numel() * 4


def seen(counts: dict, key: str) -> int:
    """How many records the plain walk marked in counts[key]."""
    return int(counts[key].sum()) if key in counts else 0


def walk_counts(counts: dict) -> dict:
    """The plain walk's counts for a log line: its work, and the nodes and
    triangle slots it tested."""
    out = {k: v for k, v in counts.items() if not torch.is_tensor(v)}
    out.update(nodes=seen(counts, "node_seen"),
               slots=seen(counts, "slot_seen"))
    return out


def bound(name: str, rays: int, counts: dict, accel) -> dict:
    """The kernel's bound for `rays` rays whose walk did `counts`."""
    table_bytes = (seen(counts, "node_seen") * (24 + 12)
                   + seen(counts, "slot_seen") * (36 + 4 + 4 + 1))
    live = counts["rays"]
    nbytes = (live * (32 + OUT_BYTES[name])
              + (rays - live) * (4 + OUT_BYTES[name]) + table_bytes)
    ops = (OPS_PER_RAY * live
           + OPS_PER_BOX * counts.get("boxes", 0)
           + OPS_PER_TRI * counts.get("tris", 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "byte_ms": byte_ms, "op_ms": op_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def pair(name: str, kernels, bvh, accel):
    """(kernel wrapper, plain version) of a kernel on accel's tables, each
    a function of (o, d, t_max, exclude, vis_mask)."""
    if name == "rls_nearest":
        return (partial(kernels.nearest, accel.packed),
                partial(bvh.intersect, accel.tree, accel.tris))
    return (partial(kernels.occluded, accel.packed),
            partial(bvh.occluded, accel.tree, accel.tris))


def run_all(fn, queries) -> None:
    for q in queries:
        fn(*q)


def kernel_ms(kern, queries, reps: int) -> tuple:
    """(device_ms, call_ms) of one pass of the kernel over queries."""
    run = partial(run_all, kern, queries)
    return device_ms(run, reps), cuda_ms(run, reps)


def time_kernels(accel, calls, bvh, kernels):
    """Per kernel: (device ms, call ms, plain ms, rays, launches) for all
    of the frame's queries of that kernel, run back to back."""
    out = {}
    for name in REPLACES:
        mine = [c[1:] for c in calls if c[0] == name]
        kern, walk = pair(name, kernels, bvh, accel)
        # one pass of the plain walk (compare() has warmed it), then the
        # kernel twice
        pm = events_ms(lambda: run_all(walk, mine), 1)
        d1, c1 = kernel_ms(kern, mine, 10)
        d2, c2 = kernel_ms(kern, mine, 10)
        out[name] = ((d1 + d2) / 2, (c1 + c2) / 2, pm,
                     sum(c[0].shape[0] for c in mine), len(mine))
    return out


def query_mix(calls, name: str) -> str:
    """The rays of a kernel's queries: dead (t_max <= 0), with a finite
    t_max, with an exclude."""
    mine = [c for c in calls if c[0] == name]
    dead = sum(int((c[3] <= 0).sum()) for c in mine)
    finite = sum(int(((c[3] > 0) & (c[3] < 1e29)).sum()) for c in mine)
    excl = sum(int((c[4] >= 0).sum()) for c in mine)
    return (f"{len(mine)} queries ({dead} rays dead with t_max <= 0, "
            f"{finite} with a finite t_max, {excl} with an exclude)")


def query_kinds(calls) -> dict:
    """The query kinds of a frame's calls over both kernels: march steps
    (a finite t_max and an exclude), dead lanes (t_max <= 0) and launches
    with no live lane."""
    out = {"march_steps": 0, "dead_lanes": 0, "no_live_launches": 0}
    for c in calls:
        tmax, ex = c[3], c[4]
        out["march_steps"] += int(((tmax > 0) & (tmax < 1e29)
                                   & (ex >= 0)).sum())
        out["dead_lanes"] += int((tmax <= 0).sum())
        out["no_live_launches"] += int(not bool((tmax > 0).any()))
    return out


def dead_lanes(calls, name: str) -> dict:
    """The dead lanes (t_max <= 0) of a kernel's queries: launches with no
    live lane, and how the live lanes fall into 32-lane groups."""
    out = {"launches": 0, "no_live": 0, "rays": 0, "live": 0, "groups": 0,
           "live_groups": 0}
    for c in calls:
        if c[0] != name:
            continue
        live = c[3] > 0
        pad = torch.zeros((-live.numel()) % 32, dtype=torch.bool,
                          device=live.device)
        groups = torch.cat([live, pad]).view(-1, 32).any(1)
        n_live = int(live.sum())
        out["launches"] += 1
        out["no_live"] += int(n_live == 0)
        out["rays"] += live.numel()
        out["live"] += n_live
        out["groups"] += groups.numel()
        out["live_groups"] += int(groups.sum())
    return out


def reset(kernels) -> None:
    """Zero the launch counts of the query kernels (`kernels`, ops/
    intersect.py), of the draws' kernels (ops/rng.py) and of the lobes'
    (ops/bsdf.py)."""
    from rlshaders_tpu_torch.ops import bsdf as lobe_kernels
    from rlshaders_tpu_torch.ops import rng as rng_kernels

    for counts in (kernels.LAUNCHES, kernels.PATH_LAUNCHES,
                   rng_kernels.LAUNCHES, lobe_kernels.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launched(kernels) -> dict:
    """Launches per kernel since `reset`: the query kernels', the draws'
    and the lobes'."""
    from rlshaders_tpu_torch.ops import bsdf as lobe_kernels
    from rlshaders_tpu_torch.ops import rng as rng_kernels

    return {**kernels.LAUNCHES, **rng_kernels.LAUNCHES,
            **lobe_kernels.LAUNCHES}


def path_launches(kernels) -> dict:
    return {k: n for k, n in kernels.PATH_LAUNCHES.items() if n}


def barred_render(render, bvh, scene, accel, **kw):
    """One timed call of render (`wavefront.render` or a sharded render)
    with the plain walk barred: (output, seconds)."""
    def barred(*args, **kwargs):
        raise AssertionError("the plain BVH walk was called on the card")

    real = bvh.intersect, bvh.occluded
    bvh.intersect = bvh.occluded = barred
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render(scene, accel, seed=SEED, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        bvh.intersect, bvh.occluded = real


def check_launched(launches: dict, what: str) -> None:
    """Both query kernels and the threefry draw (every frame's camera
    jitter) launched."""
    for k in (*REPLACES, "rls_rng_threefry"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by {what}")


def check_planes(out, size) -> None:
    for k, v in out.items():
        if k == "__stats__":
            continue
        if tuple(v.shape) != (size, size, 3):
            raise AssertionError(f"{k} has shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite values in {k}")
    if not float(out["RGBA"].mean()) > 0.0:
        raise AssertionError("black frame")


def host_planes(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items() if k != "__stats__"}


def frames_agree(tag: str, got: dict, ref: dict, names=("cuda", "cpu"),
                 tol=(PIX_TOL, PIX_FRAC, MEAN_RTOL)) -> None:
    """Every plane of two frames (numpy planes by name): the share of
    pixels within pix_tol and the relative difference of the means."""
    pix_tol, pix_frac, mean_rtol = tol
    for k in ref:
        a, b = got[k], ref[k]
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"[{tag}] {k}: shape {a.shape} or not "
                                 f"finite")
        within = float((np.abs(a - b).max(-1) <= pix_tol).mean())
        mean_err = abs(float(a.mean()) - float(b.mean())) / max(
            abs(float(b.mean())), 1e-6)
        log(f"[{tag}] {k}: share of pixels within {pix_tol}: {within:.4f}, "
            f"mean {names[0]} {a.mean():.6f} {names[1]} {b.mean():.6f} (rel "
            f"{mean_err:.3g})")
        if within < pix_frac or mean_err > mean_rtol:
            raise AssertionError(f"[{tag}] {k}: the {names[0]} and "
                                 f"{names[1]} frames disagree")


def cuda_vs_cpu(wavefront, tag, scenes, tol, **kw):
    """Render on the card and on the CPU and compare every plane."""
    small = {dev: host_planes(wavefront.render(sc, ac, seed=SEED, **kw))
             for dev, (sc, ac) in scenes.items()}
    frames_agree(tag, small["cuda"], small["cpu"], tol=tol)


def profile_frame(wavefront, tag, scene, accel, **kw) -> None:
    """Device time of one frame by kernel (torch.profiler): prints the
    device busy share and the largest kernels. Only the card's activity is
    recorded: with the host's on too, a kernel's time is listed under its
    aten op as well as under its own name, and a sum over the rows counts
    it twice."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wavefront.render(scene, accel, seed=SEED, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev = sorted(((ms, n, key) for key, (ms, n) in device_events(prof).items()),
                 reverse=True)
    total = sum(ms for ms, _, _ in dev)
    kernels = sum(n for _, n, key in dev if not key.startswith("Mem"))
    log(f"[{tag}] profile: wall {wall:.4f} s (profiled), device time "
        f"{total:.4f} ms, busy share {total / 1e3 / wall:.4f}, kernels "
        f"run {kernels}; reading the profile took "
        f"{time.perf_counter() - t1:.1f} s")
    for ms, n, key in dev[:8]:
        log(f"[{tag}]   {ms:10.4f} ms  {n:8d} x  {key[:110]}")


def jwalk_rays(scene, accel, tracemod, rng, cameramod):
    """tools/trace_decomp2.py's two ray sets on the scene: coherent camera
    rays (256x256, AA 2) and cosine-bounce rays about +z from their hits,
    offset 1e-3 along the new direction (misses bounce from t = 1e30)."""
    n = JWALK_RAYS
    key = rng.PRNGKey(0)
    rays = cameramod.generate(scene.camera, key, 2, 256, 256)
    o, d = rays.origin[:n].contiguous(), rays.direction[:n].contiguous()
    hit = tracemod.nearest(accel, o, d, vis_mask=1)
    po = o + d * hit.t[:, None]
    u = rng.uniform(key, (n, 2), o.device)
    r = torch.sqrt(u[:, 0])
    phi = 2 * np.pi * u[:, 1]
    d2 = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                      torch.sqrt(1.0 - u[:, 0])], -1)
    return {"coherent": (o, d), "incoherent": ((po + 1e-3 * d2), d2)}


def disney_step(disney, rng, V3, w: int, h: int, spp: int,
                clearcoat: float, device):
    """bench.py's `make_scene_batch` and `step` through the port's
    bsdf/disney.py: returns (step, draws), functions of a key. `step`
    draws (spp, w*h, 4) uniforms as bench.py does (rng.uniform is
    jax.random.uniform bit for bit) and returns the mean estimate V3;
    `draws` is its draw alone."""
    n = w * h
    i = torch.arange(n, device=device)
    x = (i % w).to(torch.float32) / w
    y = (i // w).to(torch.float32) / h

    def full(v):
        return torch.full((n,), v, device=device)

    params = disney.make_params(
        base_color=V3(0.7 * torch.ones_like(x), 0.3 + 0.4 * x, 0.2 + 0.6 * y),
        roughness=0.05 + 0.9 * x, metallic=y, specular=full(0.8),
        specular_tint=full(0.3), anisotropic=0.3 * x, sheen=0.5 * y,
        sheen_tint=full(0.5), clearcoat=full(clearcoat),
        clearcoat_gloss=full(0.7), subsurface=full(0.2))
    t = 0.3 + 0.5 * y
    wo = V3(torch.sqrt(1.0 - t * t), torch.zeros_like(t), t)
    cc = disney.has_clearcoat(params)

    def draws(key):
        return rng.uniform(key, (spp, n, 4), device)

    def step(key):
        u = draws(key)
        zero = torch.zeros(n, device=device)
        acc = V3(zero, zero, zero)
        for s in range(spp):
            us = u[s]
            wi_s = disney.sample_specular(params, wo, us[:, 0], us[:, 1], cc)
            f_s = disney.eval_specular_cos(params, wo, wi_s, cc)
            p_s = disney.pdf_specular(params, wo, wi_s, cc)
            p_sd = disney.pdf_diffuse(params, wo, wi_s)
            w_s = p_s / torch.clamp_min(p_s + p_sd, 1e-9)
            wi_d = disney.sample_diffuse(params, wo, us[:, 2], us[:, 3])
            f_d = disney.eval_diffuse_cos(params, wo, wi_d)
            p_d = disney.pdf_diffuse(params, wo, wi_d)
            p_ds = disney.pdf_specular(params, wo, wi_d, cc)
            w_d = p_d / torch.clamp_min(p_d + p_ds, 1e-9)
            acc = acc + (f_s * (w_s / torch.clamp_min(p_s, 1e-9))
                         + f_d * (w_d / torch.clamp_min(p_d, 1e-9)))
        return acc * (1.0 / spp)

    return step, draws


def check_shape(t_check: str, shape: str, scene, accel, aa: int,
                check: int):
    """Both kernels held to the plain walk on every query of a check x
    check, AA `aa` frame of `scene` rendered through `accel`, and timed on
    those queries (the `shape`): the compare results, the times and the
    bounds, per kernel. Raises on a mismatch."""
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels

    t0 = time.perf_counter()
    calls = capture_queries(scene, accel, wavefront, tracemod,
                            aa_samples=aa, xres=check, yres=check)
    reset(kernels)
    res = compare(accel, calls, bvh, kernels)
    log(f"[{t_check}] captured and compared in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{accel.tree.tri_order.shape[0]} triangles, "
        f"{accel.tree.first.shape[0]} nodes, tables {table_bytes(accel)} B "
        f"({accel.packed.path} path): "
        f"launches by table path {path_launches(kernels)}")
    for k in REPLACES:
        dl = dead_lanes(calls, k)
        log(f"[{t_check}] {k}: {res[k][1]} rays in {query_mix(calls, k)}, "
            f"{res[k][0]} mismatches, max abs err {res[k][2]:.3g}; "
            f"{dl['no_live']} launches with no live lane, live share "
            f"{dl['live'] / dl['rays']:.4f}")
        if res[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version on "
                                 f"the {shape} frame")
    times, bounds = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, walk = pair(k, kernels, bvh, accel)
        pm = events_ms(lambda: run_all(walk, mine), 1)
        dm, cm = kernel_ms(kern, mine, 5)
        r = sum(c[0].shape[0] for c in mine)
        times[k] = (dm, cm, pm, r, len(mine))
        b = bounds[k] = bound(k, r, res[k][3], accel)
        log(f"[{t_check}] {k}: all {r} rays of the {shape} frame's "
            f"{len(mine)} queries: device {dm:.4f} ms, call {cm:.4f} ms "
            f"({dm / len(mine) * 1e3:.2f} / {cm / len(mine) * 1e3:.2f} us "
            f"per launch), plain {pm:.4f} ms; walk "
            f"{walk_counts(res[k][3])}; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), share "
            f"of device time {b['bound_ms'] / dm:.4f}")
    del calls
    log(f"[{t_check}] phase {time.perf_counter() - t0:.1f} s")
    return res, times, bounds


def scene_phases(tags, path: str, aa: int, check: int, cpu_size: int,
                 shape: str, lit_plane: str) -> dict:
    """Three phases on one scene file (tags: their three numbers): both
    kernels held to the plain walk on every query of a check x check, AA
    `aa` frame, and timed there (the `shape`); the frame at the scene's
    own options through the kernels (counts reset, plain walk barred),
    every plane checked and `lit_plane` above 0, with one profiled tile;
    the frame on the card and on the CPU at cpu_size, AA 2. Returns what
    the JSON line reads: per kernel the compare results, the times and
    bound of the shape, and the frame's launches."""
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build

    t_check, t_path, t_cpu = (str(t) for t in tags)
    # ---- every query of a check x check frame ----
    scene = build(path)
    accel = tracemod.build(scene.geometry)
    res, times, bounds = check_shape(t_check, shape, scene, accel, aa, check)

    # ---- the path: the scene at its own options ----
    t0 = time.perf_counter()
    reset(kernels)
    out, dt = barred_render(wavefront.render, bvh, scene, accel)
    launches = launched(kernels)
    o = scene.options
    check_planes(out, o.xres)
    check_launched(launches, f"the {shape} render")
    if not float(out[lit_plane].mean()) > 0.0:
        raise AssertionError(f"the {lit_plane} AOV is black")
    tex = scene.textures
    log(f"[{t_path}] texture table: {texture_bytes(tex)} B "
        f"({tex.data.shape[0]} texels, levels {tex.n_levels.tolist()}, "
        f"offsets and sizes included)")
    stats = out["__stats__"]
    rays = stats["nearest_rays"] + stats["shadow_rays"]
    means = {k: round(float(v.mean()), 6) for k, v in out.items()
             if k != "__stats__"}
    log(f"[{t_path}] {shape} {o.xres}x{o.yres} AA {o.aa_samples}: "
        f"{dt:.4f} s/frame, plane means {means}, all planes finite, "
        f"launches {launches}, by table path {path_launches(kernels)}, "
        f"nearest rays {stats['nearest_rays']}, shadow rays "
        f"{stats['shadow_rays']}, {rays / dt / 1e6:.3f} Mrays/s "
        f"(nearest+shadow)")
    del out
    profile_frame(wavefront, t_path, scene, accel, aa_samples=aa,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    log(f"[{t_path}] phase {time.perf_counter() - t0:.1f} s")

    # ---- the frame on the card and on the CPU ----
    t0 = time.perf_counter()
    cscene = build(path, device="cpu")
    cuda_vs_cpu(wavefront, t_cpu, {
        "cuda": (scene, accel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=cpu_size,
        yres=cpu_size)
    log(f"[{t_cpu}] phase {time.perf_counter() - t0:.1f} s")
    return {"compare": res, "times": times, "bounds": bounds,
            "launches": launches}


def disney_step_phase(card: str) -> dict:
    """Phase 16: bench.py's Disney step through the port's bsdf/disney.py,
    clearcoat 0.8 and 0; returns Gsamples/s by clearcoat."""
    from rlshaders_tpu_torch.bsdf import disney
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.core.vec3 import V3

    t0 = time.perf_counter()
    rates = {}
    for cc in (0.8, 0.0):
        step, draws = disney_step(disney, rng, V3, STEP_W, STEP_H, STEP_SPP,
                                  cc, DEVICE)
        key = rng.stream(0)
        est = step(key)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(est.aos()).all()):
            raise AssertionError("the Disney step is not finite")
        keys = iter(range(1, 100))
        ms = events_ms(lambda: step(rng.fold(key, next(keys))), 3)
        draw_ms = events_ms(lambda: draws(rng.fold(key, next(keys))), 3)
        rate = STEP_W * STEP_H * STEP_SPP * 2 / (ms / 1e3) / 1e9
        rates[cc] = rate
        log(f"[16] Disney step {STEP_W}x{STEP_H} SPP {STEP_SPP} clearcoat "
            f"{cc}: {ms:.4f} ms a step (of which the draws {draw_ms:.4f} "
            f"ms), {rate:.4f} Gsamples/s, mean estimate "
            f"{[round(float(c.mean()), 6) for c in est]}; {card}")
        del step, draws, est
    log(f"[16] phase {time.perf_counter() - t0:.1f} s")
    return rates


def texture_bytes(tex) -> int:
    return sum(t.numel() * t.element_size() for t in tex)


def trace_set_text(path: str) -> str:
    """The scene at `path` with `trace_sets "setA"` on the polymeshes of
    TRACE_SET_MESHES (about half of them, the floor among them)."""
    with open(path) as f:
        src = f.read()
    for name in TRACE_SET_MESHES:
        head = f"polymesh\n{{\n name {name}\n"
        if head not in src:
            raise AssertionError(f"no polymesh {name} in {path}")
        src = src.replace(head, head + ' trace_sets "setA"\n')
    return src


def cli_phase(card: str) -> dict:
    """Phase 20: `cli render` of scenes/textured_disk.ass at its own
    options, two passes, AOVs and the profile; every EXR read back; the
    beauty against the mean of two direct renders; what the command adds
    around `render`, piece by piece. Returns the launches of the CLI run
    and the textured frame at seed 0 (phase 22's golden)."""
    from rlshaders_tpu_torch import cli
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.io import exr
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.exr")
        reset(kernels)
        t1 = time.perf_counter()
        rc = cli.main(["render", TEXTURED, "-o", out, "--passes", "2",
                       "--aovs", "--profile"])
        wall = time.perf_counter() - t1
        launches = launched(kernels)
        if rc != 0:
            raise AssertionError(f"cli render returned {rc}")
        check_launched(launches, "cli render")
        files = sorted(f for f in os.listdir(tmp) if f.endswith(".exr"))
        want = ["cli.exr"] + [f"cli.{n}.exr" for n in CLI_AOVS]
        if files != sorted(want):
            raise AssertionError(f"cli render wrote {files}")
        planes = {f: exr.read_rgb(os.path.join(tmp, f)) for f in files}
        trace_mb = os.path.getsize(os.path.join(tmp, "cli_trace",
                                                "trace.json")) / 1e6
    scene = build(TEXTURED)
    size = (scene.options.yres, scene.options.xres, 3)
    for f, img in planes.items():
        if img.shape != size or not np.isfinite(img).all():
            raise AssertionError(f"{f}: shape {img.shape} or not finite")
    log(f"[20] cli render: {wall:.4f} s in cli.main (build, two profiled "
        f"passes, trace export, EXR writes), launches {launches}, trace "
        f"{trace_mb:.1f} MB; {card}")

    accel = tracemod.build(scene.geometry)
    passes = []
    for seed in (0, 7919):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        o = wavefront.render(scene, accel, seed=seed, tile_pixels=CLI_TILE)
        torch.cuda.synchronize()
        passes.append((o, time.perf_counter() - t1))
    (a, ta), (b, tb) = passes
    mean = ((a["RGBA"].double() + b["RGBA"].double()) / 2).float()
    mean = mean.cpu().numpy()
    half = np.spacing(np.abs(mean).astype(np.float16)).astype(np.float32)
    err = np.abs(planes["cli.exr"] - mean)
    log(f"[20] direct renders at seeds 0 and 7919: {ta:.4f} s and "
        f"{tb:.4f} s; the CLI's RGBA against their float64 mean: max abs "
        f"err {err.max():.3g}, pixels beyond one half-float spacing "
        f"{int((err > half).sum())}")
    if (err > half).any():
        raise AssertionError("the CLI's beauty is not the mean of its "
                             "passes")

    # what cli render adds around render, on this run's planes
    names = ["RGBA"] + CLI_AOVS
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc = {k: a[k].double() for k in names}
    for k in names:
        acc[k] += b[k]
    host = {k: (v / 2).float().cpu().numpy() for k, v in acc.items()}
    t_mean = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        for i in range(2):
            exr.write_rgb(os.path.join(tmp, f"flush{i}.exr"),
                          (acc["RGBA"] / (i + 1)).float().cpu().numpy())
        for k, v in host.items():
            exr.write_rgb(os.path.join(tmp, f"{k}.exr"), v)
        t_exr = time.perf_counter() - t1
    nbytes = sum(v.nbytes for v in host.values())
    log(f"[20] around render: the float64 sum and mean of {len(names)} "
        f"planes and their host copy ({nbytes} B) {t_mean * 1e3:.4f} ms; "
        f"{len(names) + 2} EXR writes (two flushes) {t_exr * 1e3:.4f} ms; "
        f"{card}")
    log(f"[20] phase {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "golden": a["RGBA"].cpu().numpy()}


def trace_set_phase() -> dict:
    """Phase 21: both kernels held to the plain walk on every query of a
    64x64, AA 3 frame of the textured scene rendered through each subset
    accel of its trace set (inclusive, exclusive), and timed there."""
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.scene.build import build_text

    t0 = time.perf_counter()
    scene = build_text(trace_set_text(TEXTURED),
                       base_dir=os.path.dirname(TEXTURED))
    if scene.trace_set_names != ["setA"]:
        raise AssertionError(f"trace sets {scene.trace_set_names}")
    members = int(((scene.geometry.visibility & (1 << 8)) != 0).sum())
    log(f"[21] trace set setA: {members} of {scene.geometry.v0.shape[0]} "
        f"triangles, meshes {list(TRACE_SET_MESHES)}")
    out = {}
    for inclusive in (True, False):
        tag = "inclusive" if inclusive else "exclusive"
        accel = tracemod.build_trace_set(scene.geometry, 0, inclusive)
        log(f"[21] {tag}: {accel.tree.tri_order.shape[0]} triangles, "
            f"{accel.tree.first.shape[0]} nodes, {accel.packed.path} path")
        out[tag] = check_shape("21", f"trace_sets_{tag}", scene, accel,
                               TEXTURED_AA, TEXTURED_CHECK)
    log(f"[21] phase {time.perf_counter() - t0:.1f} s")
    return out


def suite_phase(golden_textured: np.ndarray) -> None:
    """Phase 22: `cli test`, `list` and `display` on a suite written to a
    temporary directory: 0001 the Disney spheres and 0002 the textured
    scene, each with the port's own card render at seed 0 as its golden
    (both pass), and 0003 the textured scene with the Disney golden (must
    fail)."""
    from rlshaders_tpu_torch import cli
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.io import exr
    from rlshaders_tpu_torch.scene.build import build
    from rlshaders_tpu_torch.scene.texture import decode_png

    t0 = time.perf_counter()
    scene = build(DISNEY)
    o = wavefront.render(scene, tracemod.build(scene.geometry), seed=0,
                         tile_pixels=CLI_TILE)
    golden_disney = o["RGBA"].cpu().numpy()
    del o, scene
    cases = {"0001": (DISNEY, golden_disney, "disney spheres"),
             "0002": (TEXTURED, golden_textured, "textured disk"),
             "0003": (TEXTURED, golden_disney,
                      "textured with the wrong golden")}
    with tempfile.TemporaryDirectory() as tmp:
        suite = os.path.join(tmp, "suite")
        for case, (path, golden, desc) in cases.items():
            if cli.main(["mkdir", "--suite", suite, "--desc", desc]) != 0:
                raise AssertionError(f"cli mkdir failed for {case}")
            data = os.path.join(suite, "mtoa", case, "data")
            shutil.copy(path, data)
            if path == TEXTURED:
                shutil.copytree(os.path.join(os.path.dirname(TEXTURED),
                                             "data"),
                                os.path.join(data, "data"))
            exr.write_rgb(os.path.join(suite, "mtoa", case, "ref",
                                       "ref.exr"), golden)
        listing = io.StringIO()
        with contextlib.redirect_stdout(listing):
            cli.main(["list", "--suite", suite])
        want = [f"{c}  {d}" for c, (_, _, d) in cases.items()]
        if listing.getvalue().splitlines() != want:
            raise AssertionError(f"cli list printed {listing.getvalue()!r}")
        report = os.path.join(tmp, "report.csv")
        with contextlib.chdir(tmp):
            rc = cli.main(["test", "--suite", suite, "--report", report,
                           "--save"])
        with open(report) as f:
            rows = [r.split(",") for r in f.read().splitlines()[1:]]
        log(f"[22] cli test rc {rc}: " + "; ".join(
            f"{r[0]} {r[2]} masked rmse {r[3]} full {r[4]} {r[7]} s"
            for r in rows))
        status = [(r[0], r[2]) for r in rows]
        if status != [("0001", "OK"), ("0002", "OK"), ("0003", "FAIL")]:
            raise AssertionError(f"cli test reported {status}")
        if rc != 1 or max(float(r[4]) for r in rows[:2]) >= 1e-3:
            raise AssertionError("cli test: rc or rmse off")
        for case in cases:
            shutil.copy(os.path.join(tmp, "out", f"test_{case}.exr"),
                        os.path.join(suite, "mtoa", case, "ref",
                                     "test_tpu.exr"))
        sheets = os.path.join(tmp, "display")
        if cli.main(["display", "--suite", suite, "--outdir", sheets]) != 0:
            raise AssertionError("cli display failed")
        for case in cases:
            with open(os.path.join(sheets, f"{case}.png"), "rb") as f:
                img = decode_png(f.read())
            h, w = golden_textured.shape[:2]
            if img.shape != (h, 3 * w, 3) or not img.any():
                raise AssertionError(f"display sheet {case}: {img.shape}")
        log(f"[22] cli list, test and display: the listing, the three rows "
            f"and three decodable {h}x{3 * w} sheets as expected")
    log(f"[22] phase {time.perf_counter() - t0:.1f} s")


def padding_stats(wavefront, rng, cameramod, scene, accel, world: int,
                  tile_pixels: int) -> dict:
    """The ray counts of the tiles that pad the demo frame's tiles to a
    multiple of `world`, rendered alone at their global indices."""
    n_rays = SIZE * SIZE * AA * AA
    tile_rays = min(tile_pixels * AA * AA, n_rays)
    n_tiles = -(-n_rays // tile_rays)
    n_tiles_p = -(-n_tiles // world) * world
    key = rng.stream(scene.options.aa_seed + SEED)
    rays = cameramod.generate(scene.camera, rng.fold(key, 77), AA, SIZE,
                              SIZE)
    rays = wavefront._pad_rays(rays, n_tiles_p * tile_rays - n_rays)
    tr = wavefront.TileRenderer(scene, accel, AA, xres=SIZE)
    for gt in range(n_tiles, n_tiles_p):
        tr.render_tile_at(rays, gt * tile_rays, tile_rays,
                          rng.fold(key, 1000 + gt))
    return tr.stats


def mesh_world1_phase(card: str) -> dict:
    """Phase 23: `render_sharded` at world size 1 over NCCL in this
    process, the demo frame of phase 4 through the kernels (counts reset,
    plain walk barred), held to `render`'s frame; both frames timed in
    three interleaved pairs; the Disney step of phase 16 through
    `sharded_shade_step` on the (1,) mesh. Returns the launches."""
    import torch.distributed as dist

    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    scene, accel = mesh.demo_scene(skin=False)
    kw = dict(aa_samples=AA, xres=SIZE, yres=SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            m = mesh.make_mesh()
            sharded = partial(mesh.render_sharded, mesh=m)
            reset(kernels)
            out, dt = barred_render(sharded, bvh, scene, accel, **kw)
            launches = launched(kernels)
            check_planes(out, SIZE)
            check_launched(launches, "render_sharded at world size 1")
            ref = wavefront.render(scene, accel, seed=SEED, **kw)
            if out["__stats__"] != ref["__stats__"]:
                raise AssertionError(f"[23] ray counts {out['__stats__']} "
                                     f"against render's {ref['__stats__']}")
            frames_agree("23", host_planes(out), host_planes(ref),
                         ("render_sharded", "render"))
            log(f"[23] render_sharded over NCCL, world size 1, mesh "
                f"{m.mesh_dim_names} {tuple(m.shape)} ({m.device_type}), "
                f"demo {SIZE}x{SIZE} AA {AA}: {dt:.4f} s, launches "
                f"{launches}, stats {out['__stats__']}; {card}")
            pairs = []
            for _ in range(3):
                pair_s = []
                for fn in (wavefront.render, sharded):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fn(scene, accel, seed=SEED, **kw)
                    torch.cuda.synchronize()
                    pair_s.append(time.perf_counter() - t1)
                pairs.append(tuple(pair_s))
            log(f"[23] seconds a frame, (render, render_sharded) in turns: "
                + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in pairs))
            del out, ref

            params, wo = mesh.demo_batch(STEP_W * STEP_H)
            key = rng.stream(0)
            est = mesh.sharded_shade_step(m, params, wo, key, STEP_SPP)
            plain = mesh.shade_step(params, wo, key, STEP_SPP)
            err = float((est - plain).abs().max())
            if not bool(torch.isfinite(est).all()) or err > 1e-5:
                raise AssertionError(f"[23] sharded_shade_step: max abs err "
                                     f"{err} against shade_step")
            keys = iter(range(1, 100))
            ms = events_ms(lambda: mesh.sharded_shade_step(
                m, params, wo, rng.fold(key, next(keys)), STEP_SPP), 3)
            rate = STEP_W * STEP_H * STEP_SPP * 2 / (ms / 1e3) / 1e9
            log(f"[23] sharded_shade_step over (1,), demo_batch("
                f"{STEP_W}*{STEP_H}) SPP {STEP_SPP}: {ms:.4f} ms a step, "
                f"{rate:.4f} Gsamples/s (counted as phase 16), max abs err "
                f"against shade_step {err:.3g}; {card}")
            del params, wo, est, plain
        finally:
            dist.destroy_process_group()
    log(f"[23] phase {time.perf_counter() - t0:.1f} s")
    return launches


def mesh_rank(rank: int) -> dict:
    """Phase 24 on one of two ranks (gloo, both on cuda:0): the demo with
    its rlSkin blob through `render_sharded` at each tile size of
    MESH_TILES (counts reset, plain walk barred), then `sharded_shade_step`
    on the (1, 2) and (2,) meshes. Returns rank 0's planes and estimates
    and every rank's launches, ray counts and seconds."""
    import torch.distributed as dist

    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.parallel import mesh

    kernels.build()
    scene, accel = mesh.demo_scene()
    m = mesh.make_mesh()
    planes, mine = {}, {}
    for tile in MESH_TILES:
        reset(kernels)
        out, dt = barred_render(partial(mesh.render_sharded, mesh=m), bvh,
                                scene, accel, aa_samples=AA, xres=SIZE,
                                yres=SIZE, tile_pixels=tile)
        mine[tile] = {"launches": launched(kernels),
                      "stats": out.pop("__stats__"), "seconds": dt}
        planes[tile] = host_planes(out)
    params, wo = mesh.demo_batch(STEP_W * STEP_H)
    shade = {}
    for sp in (2, 1):
        mm = mesh.make_mesh(sp=sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = mesh.sharded_shade_step(mm, params, wo, rng.stream(0),
                                      STEP_SPP)
        torch.cuda.synchronize()
        shade[sp] = (est.cpu().numpy(), time.perf_counter() - t0)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"planes": planes, "ranks": ranks, "shade": shade,
            "mesh": (m.mesh_dim_names, tuple(m.shape), m.device_type)}


def mesh_world2_phase(card: str) -> dict:
    """Phase 24: `mesh_rank` on two ranks over gloo on the one card; each
    tile size's frame held to `render`'s, every rank's launches above 0,
    the ranks' ray counts to the single process's plus the padding tile's,
    the Disney step to `shade_step`'s arithmetic in one process. Returns
    the launches of both ranks and both frames."""
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.integrator import camera as cameramod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    res = mesh.launch(mesh_rank, 2, backend="gloo", same_device=True,
                      timeout_s=MESH_TIMEOUT_S)
    t_launch = time.perf_counter() - t0
    log(f"[24] two ranks over gloo on cuda:0, mesh {res['mesh']}: the "
        f"launch took {t_launch:.1f} s (process start, CUDA context, both "
        f"frames, both steps); {card}")
    scene, accel = mesh.demo_scene()
    # a warm-up frame, so that the timed frames below pay no first calls
    wavefront.render(scene, accel, seed=SEED, aa_samples=AA, xres=SIZE,
                     yres=SIZE)
    launches = dict.fromkeys((*REPLACES, *RNG_KERNELS, *LOBE_KERNELS), 0)
    for tile in MESH_TILES:
        per = [r[tile] for r in res["ranks"]]
        for i, r in enumerate(per):
            check_launched(r["launches"], f"rank {i} at tile {tile}")
            for k, n in r["launches"].items():
                launches[k] += n
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = wavefront.render(scene, accel, seed=SEED, aa_samples=AA,
                               xres=SIZE, yres=SIZE, tile_pixels=tile)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t1
        frames_agree(f"24 tile {tile}", res["planes"][tile], host_planes(ref),
                     ("render_sharded", "render"))
        pad = padding_stats(wavefront, rng, cameramod, scene, accel, 2, tile)
        total = {k: sum(r["stats"][k] for r in per) for k in per[0]["stats"]}
        want = {k: v + pad[k] for k, v in ref["__stats__"].items()}
        if total != want:
            raise AssertionError(f"[24] tile {tile}: the ranks' ray counts "
                                 f"{total}, expected {want}")
        log(f"[24] tile_pixels {tile}: " + "; ".join(
            f"rank {i} {r['seconds']:.4f} s, {r['stats']['tiles']} tiles, "
            f"launches {r['launches']}" for i, r in enumerate(per))
            + f"; render in one process {t_ref:.4f} s; the ranks' rays = "
            f"render's + the padding tiles' {pad}")
    params, wo = mesh.demo_batch(STEP_W * STEP_H)
    key = rng.stream(0)
    half = STEP_SPP // 2
    ref = {2: (mesh.shade_step(params, wo, rng.fold_in(key, 0), half)
               + mesh.shade_step(params, wo, rng.fold_in(key, 1), half)) / 2}
    n = STEP_W * STEP_H
    ref[1] = torch.cat([mesh.shade_step(mesh._rows(params, rows), wo[rows],
                                        key, STEP_SPP)
                        for rows in (slice(0, n // 2), slice(n // 2, n))])
    for sp, (est, dt) in res["shade"].items():
        err = float(np.abs(est - ref[sp].cpu().numpy()).max())
        log(f"[24] sharded_shade_step over {('(2,)', '(1, 2)')[sp - 1]}, "
            f"demo_batch({STEP_W}*{STEP_H}) SPP {STEP_SPP}: {dt:.4f} s on "
            f"rank 0 (first call), max abs err against shade_step in one "
            f"process {err:.3g}")
        if not np.isfinite(est).all() or err > 1e-5:
            raise AssertionError(f"[24] sharded_shade_step sp {sp} is off")
    log(f"[24] phase {time.perf_counter() - t0:.1f} s")
    return launches


def jpeg_phase(card: str) -> dict:
    """Phase 25: the committed JPEGs decoded without PIL and held to the
    pinned digests; scenes/textured_disk.ass with its images named .jpg at
    its own options through the kernels (counts reset, plain walk barred);
    its 32x32 frame on the card and on the CPU. Returns the launches."""
    import hashlib

    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build_text
    from rlshaders_tpu_torch.scene.jpeg import decode_jpeg

    t0 = time.perf_counter()
    for path, digest in JPEG_DIGESTS.items():
        with open(path, "rb") as f:
            data = f.read()
        t1 = time.perf_counter()
        px = decode_jpeg(data)
        dt = time.perf_counter() - t1
        got = hashlib.sha256(px.tobytes()).hexdigest()
        log(f"[25] {path}: {len(data)} B -> {px.shape} in {dt * 1e3:.2f} ms "
            f"(host), sha256 {got[:16]}...")
        if got != digest:
            raise AssertionError(f"[25] {path} decodes to {got}, PIL's "
                                 f"decode is {digest}")
    if "PIL" in sys.modules:
        raise AssertionError("[25] PIL was imported")
    with open(TEXTURED) as f:
        src = f.read()
    if src.count(".png") != 3:
        raise AssertionError(f"{TEXTURED} names {src.count('.png')} PNGs")
    src = src.replace(".png", ".jpg")
    base = os.path.dirname(TEXTURED)
    t1 = time.perf_counter()
    scene = build_text(src, base_dir=base)
    log(f"[25] built the JPEG-textured scene in {time.perf_counter() - t1:.2f}"
        f" s; texture table {texture_bytes(scene.textures)} B")
    accel = tracemod.build(scene.geometry)
    reset(kernels)
    out, dt = barred_render(wavefront.render, bvh, scene, accel)
    launches = launched(kernels)
    o = scene.options
    check_planes(out, o.xres)
    check_launched(launches, "the JPEG-textured render")
    stats = out["__stats__"]
    log(f"[25] JPEG-textured {o.xres}x{o.yres} AA {o.aa_samples}: "
        f"{dt:.4f} s/frame, mean RGB {float(out['RGBA'].mean()):.6f}, "
        f"launches {launches}, nearest rays {stats['nearest_rays']}, shadow "
        f"rays {stats['shadow_rays']}; {card}")
    del out
    cscene = build_text(src, device="cpu", base_dir=base)
    cuda_vs_cpu(wavefront, "25", {
        "cuda": (scene, accel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=TEXTURED_CPU,
        yres=TEXTURED_CPU)
    log(f"[25] phase {time.perf_counter() - t0:.1f} s")
    return launches


def with_images(src: str, images) -> str:
    """The textured scene's source with its three image names (the grid,
    the logo, the inverted logo) replaced in order by `images`."""
    slots = ('"data/grid.png"', '"data/logo.png"', '"data/logo.png"')
    for old, new in zip(slots, images):
        if old not in src:
            raise AssertionError(f"{TEXTURED} does not name {old}")
        src = src.replace(old, f'"data/{new}"', 1)
    return src


def image_phases(card: str, folder: str = "modes",
                 digests: dict = MODE_DIGESTS, frames: dict = IMAGE_FRAMES,
                 phases=(29, 30), check: int = 0) -> dict:
    """Phases 29-30 (or 31-32 of scenes/data/formats, 33-34 of formats_b):
    every file of scenes/data/<folder> decoded without PIL and held to its
    pinned digest; the textured scene with each frame's images through the
    kernels (counts reset, plain walk barred), 16 + 60 launches each, both
    kernels held to the plain walk on every query of a check x check frame
    at the scene's own AA and GI samples where `check` is given, and its
    IMAGE_CPU x IMAGE_CPU frame on the card and the CPU. Returns the
    launches of the frames."""
    import hashlib

    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build_text
    from rlshaders_tpu_torch.scene.texture import decode_image

    pa, pb = phases
    t0 = time.perf_counter()
    names = sorted(os.listdir(f"scenes/data/{folder}"))
    paths = [f"scenes/data/{folder}/{n}" for n in names]
    if sorted(paths) != sorted(digests):
        raise AssertionError(f"[{pa}] scenes/data/{folder} holds {names}, "
                             f"the digests name {sorted(digests)}")
    decode_ms = {}
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        t1 = time.perf_counter()
        px = decode_image(data)
        dt = (time.perf_counter() - t1) * 1e3
        decode_ms[path] = dt
        got = hashlib.sha256(px.tobytes()).hexdigest()
        log(f"[{pa}] {path}: {len(data)} B -> {px.shape} in {dt:.2f} ms "
            f"(host), sha256 {got[:16]}...")
        if got != digests[path]:
            raise AssertionError(f"[{pa}] {path} decodes to {got}, PIL's "
                                 f"decode is {digests[path]}")
    biggest = max(paths, key=os.path.getsize)
    log(f"[{pa}] the largest file, {biggest} "
        f"({os.path.getsize(biggest)} B): {decode_ms[biggest]:.2f} ms host "
        f"decode; {card}")
    if "PIL" in sys.modules:
        raise AssertionError(f"[{pa}] PIL was imported")
    log(f"[{pa}] {len(paths)} files decoded in "
        f"{sum(decode_ms.values()):.2f} ms (host); phase "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with open(TEXTURED) as f:
        base_src = f.read()
    base = os.path.dirname(TEXTURED)
    launches = dict.fromkeys((*REPLACES, *RNG_KERNELS, *LOBE_KERNELS), 0)
    for tag, images in frames.items():
        src = with_images(base_src, images)
        t1 = time.perf_counter()
        scene = build_text(src, base_dir=base)
        decoded = ", ".join(
            f"{n} {decode_ms[f'scenes/data/{n}']:.2f} ms" for n in images
            if f"scenes/data/{n}" in decode_ms)
        log(f"[{pb}] frame {tag} {images}: built in "
            f"{time.perf_counter() - t1:.2f} s; texture table "
            f"{texture_bytes(scene.textures)} B; decoded in phase {pa}: "
            f"{decoded or '-'}")
        accel = tracemod.build(scene.geometry)
        reset(kernels)
        out, dt = barred_render(wavefront.render, bvh, scene, accel)
        got = launched(kernels)
        o = scene.options
        check_planes(out, o.xres)
        stats = out["__stats__"]
        log(f"[{pb}] frame {tag} {o.xres}x{o.yres} AA {o.aa_samples}: "
            f"{dt:.4f} s/frame, mean RGB {float(out['RGBA'].mean()):.6f}, "
            f"launches {got}, nearest rays {stats['nearest_rays']}, shadow "
            f"rays {stats['shadow_rays']}; {card}")
        if {k: got[k] for k in IMAGE_LAUNCHES} != IMAGE_LAUNCHES:
            raise AssertionError(f"[{pb}] frame {tag} launched {got}, "
                                 f"expected {IMAGE_LAUNCHES}")
        for k in launches:
            launches[k] += got[k]
        del out
        if check:
            t1 = time.perf_counter()
            res = compare(accel, capture_queries(
                scene, accel, wavefront, tracemod, xres=check, yres=check),
                bvh, kernels)
            for k, (bad, rays, err, _) in res.items():
                log(f"[{pb}] frame {tag} {check}x{check} AA "
                    f"{o.aa_samples}: {k} {rays} rays, {bad} mismatches "
                    f"against the plain walk, max abs err {err:.3g}")
                if bad:
                    raise AssertionError(f"[{pb}] frame {tag}: {k} "
                                         f"disagrees with its plain version")
            log(f"[{pb}] frame {tag} checked in "
                f"{time.perf_counter() - t1:.1f} s")
        cscene = build_text(src, device="cpu", base_dir=base)
        cuda_vs_cpu(wavefront, f"{pb}{tag}", {
            "cuda": (scene, accel),
            "cpu": (cscene, tracemod.build(cscene.geometry))},
            (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA,
            xres=IMAGE_CPU, yres=IMAGE_CPU)
        del scene, accel, cscene
    log(f"[{pb}] phase {time.perf_counter() - t0:.1f} s")
    return launches


def format_phases(card: str, folder: str = "formats",
                  digests: dict = FORMAT_DIGESTS,
                  frames: dict = FORMAT_FRAMES, phases=(31, 32),
                  check: int = 0, limit: float = FORMAT_PHASES_S) -> dict:
    """Phases 31-32 (or 33-34 of scenes/data/formats_b, 35-36 of
    formats_c): image_phases over the folder with its frames, within
    `limit` seconds. Returns the launches of both frames."""
    pa, pb = phases
    t0 = time.perf_counter()
    launches = image_phases(card, folder, digests, frames, phases, check)
    took = time.perf_counter() - t0
    log(f"[{pb}] phases {pa}-{pb} {took:.1f} s (at most {limit} s); {card}")
    if took > limit:
        raise AssertionError(f"[{pb}] phases {pa}-{pb} took {took:.1f} s, "
                             f"more than {limit} s")
    return launches


def format_b_phases(card: str) -> dict:
    """Phases 33-34: format_phases over scenes/data/formats_b with frames
    E and F, each held to the plain walk on every query of a
    FORMAT_B_CHECK frame."""
    return format_phases(card, "formats_b", FORMAT_B_DIGESTS,
                         FORMAT_B_FRAMES, (33, 34), FORMAT_B_CHECK)


def format_c_phases(card: str) -> dict:
    """Phases 35-36: format_phases over scenes/data/formats_c (SPIDER and
    still WebP) with frames G and H, each held to the plain walk on every
    query of a FORMAT_B_CHECK frame, within FORMAT_C_PHASES_S."""
    return format_phases(card, "formats_c", FORMAT_C_DIGESTS,
                         FORMAT_C_FRAMES, (35, 36), FORMAT_B_CHECK,
                         FORMAT_C_PHASES_S)


def format_d_phases(card: str) -> dict:
    """Phases 37-38: format_phases over scenes/data/formats_d (JPEG 2000,
    with its native tier-1, and animated WebP) with frames I and J, each
    held to the plain walk on every query of a FORMAT_B_CHECK frame,
    within FORMAT_D_PHASES_S."""
    return format_phases(card, "formats_d", FORMAT_D_DIGESTS,
                         FORMAT_D_FRAMES, (37, 38), FORMAT_B_CHECK,
                         FORMAT_D_PHASES_S)


def format_e_phases(card: str) -> dict:
    """Phases 39-40: format_phases over scenes/data/formats_e (still AVIF,
    its AV1 tiles decoded by native code) with frames K and L, each held
    to the plain walk on every query of a FORMAT_B_CHECK frame, within
    FORMAT_E_PHASES_S."""
    return format_phases(card, "formats_e", FORMAT_E_DIGESTS,
                         FORMAT_E_FRAMES, (39, 40), FORMAT_B_CHECK,
                         FORMAT_E_PHASES_S)


def bomb_phase(card: str) -> None:
    """Phase 41's first part: every file of BOMBS, each past PIL's
    decompression-bomb limit, raises ValueError naming the limit (PIL
    raises DecompressionBombError), without a pixel decoded."""
    from rlshaders_tpu_torch.scene.texture import decode_image

    t0 = time.perf_counter()
    names = sorted(os.listdir(BOMBS))
    if tuple(names) != BOMB_FILES:
        raise AssertionError(f"[41] {BOMBS} holds {names}, expected "
                             f"{BOMB_FILES}")
    for name in names:
        with open(f"{BOMBS}/{name}", "rb") as f:
            data = f.read()
        t1 = time.perf_counter()
        try:
            decode_image(data)
        except ValueError as e:
            if "decompression bomb limit" not in str(e):
                raise AssertionError(f"[41] {name}: {e}") from None
            dt = (time.perf_counter() - t1) * 1e3
            log(f"[41] {BOMBS}/{name}: {len(data)} B -> ValueError in "
                f"{dt:.2f} ms (host): {e}")
        else:
            raise AssertionError(f"[41] {name} decodes; PIL refuses it as "
                                 f"a decompression bomb")
    log(f"[41] {len(names)} bomb files refused in "
        f"{time.perf_counter() - t0:.2f} s; {card}")


def format_f_phases(card: str) -> dict:
    """Phases 41-42: the bomb files (bomb_phase), then format_phases over
    scenes/data/formats_f (quantizer matrices, film grain, image
    sequences and grids) with frames M and N, each held to the plain walk
    on every query of a FORMAT_B_CHECK frame, all within
    FORMAT_F_PHASES_S."""
    t0 = time.perf_counter()
    bomb_phase(card)
    launches = format_phases(card, "formats_f", FORMAT_F_DIGESTS,
                             FORMAT_F_FRAMES, (41, 42), FORMAT_B_CHECK,
                             FORMAT_F_PHASES_S)
    took = time.perf_counter() - t0
    log(f"[42] phases 41-42 with the bomb files {took:.1f} s (at most "
        f"{FORMAT_F_PHASES_S} s); {card}")
    if took > FORMAT_F_PHASES_S:
        raise AssertionError(f"[42] phases 41-42 took {took:.1f} s, more "
                             f"than {FORMAT_F_PHASES_S} s")
    return launches


def format_g_phases(card: str) -> dict:
    """Phases 43-44: format_phases over scenes/data/formats_g (float and
    signed TIFF, YCbCr TIFF outside JPEG, sYCC JPEG 2000, PSD and AVIF
    frames libavif scales) with frames O and P, each held to the plain
    walk on every query of a FORMAT_B_CHECK frame, within
    FORMAT_G_PHASES_S."""
    return format_phases(card, "formats_g", FORMAT_G_DIGESTS,
                         FORMAT_G_FRAMES, (43, 44), FORMAT_B_CHECK,
                         FORMAT_G_PHASES_S)


def lab_zstd_split(card: str) -> None:
    """Phase 45's split of FORMAT_H_SPLIT's decode: the milliseconds of
    its ZSTD strips (the native decoder) and of its LAB conversion
    (numpy), timed inside one decode of the file."""
    from rlshaders_tpu_torch.scene import lab, tiff, zstd

    with open(FORMAT_H_SPLIT, "rb") as f:
        data = f.read()
    spent = {"zstd": 0.0, "lab": 0.0}

    def timed(name, fn):
        def run(*args):
            t1 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[name] += (time.perf_counter() - t1) * 1e3
        return run

    strip, to_rgb = zstd.tiff_strip, lab.to_rgb
    zstd.tiff_strip, lab.to_rgb = timed("zstd", strip), timed("lab", to_rgb)
    try:
        t1 = time.perf_counter()
        tiff.decode_tiff(data)
        total = (time.perf_counter() - t1) * 1e3
    finally:
        zstd.tiff_strip, lab.to_rgb = strip, to_rgb
    log(f"[45] {FORMAT_H_SPLIT}: {total:.2f} ms (host): ZSTD strips "
        f"{spent['zstd']:.2f} ms, LAB to RGB {spent['lab']:.2f} ms, the "
        f"rest {total - spent['zstd'] - spent['lab']:.2f} ms; {card}")


def format_h_phases(card: str) -> dict:
    """Phases 45-46: format_phases over scenes/data/formats_h (ZSTD TIFF,
    LAB through LittleCMS's transform, and nine more of PIL's plugins)
    with frames Q and R, each held to the plain walk on every query of a
    FORMAT_B_CHECK frame, then the LAB ZSTD TIFF's split, all within
    FORMAT_H_PHASES_S."""
    t0 = time.perf_counter()
    launches = format_phases(card, "formats_h", FORMAT_H_DIGESTS,
                             FORMAT_H_FRAMES, (45, 46), FORMAT_B_CHECK,
                             FORMAT_H_PHASES_S)
    lab_zstd_split(card)
    took = time.perf_counter() - t0
    log(f"[46] phases 45-46 with the split {took:.1f} s (at most "
        f"{FORMAT_H_PHASES_S} s); {card}")
    if took > FORMAT_H_PHASES_S:
        raise AssertionError(f"[46] phases 45-46 took {took:.1f} s, more "
                             f"than {FORMAT_H_PHASES_S} s")
    return launches


def format_i_phases(card: str) -> dict:
    """Phases 47-48: format_phases over scenes/data/formats_i (FLI/FLC,
    PhotoCD, FITS, IPTC and damaged JPEGs) with frames S and T, each held
    to the plain walk on every query of a FORMAT_B_CHECK frame, within
    FORMAT_I_PHASES_S."""
    return format_phases(card, "formats_i", FORMAT_I_DIGESTS,
                         FORMAT_I_FRAMES, (47, 48), FORMAT_B_CHECK,
                         FORMAT_I_PHASES_S)


def same_nodes_and_leaves(a, b) -> bool:
    """Whether two builders' arrays (bbox_min, bbox_max, first, count,
    miss, order) have the same nodes and every leaf the same set of
    triangles (the order inside a leaf may differ)."""
    if not all(np.array_equal(x, y) for x, y in zip(a[:5], b[:5])):
        return False
    leaf = a[2] >= 0
    return all(set(a[5][f:f + c].tolist()) == set(b[5][f:f + c].tolist())
               for f, c in zip(a[2][leaf], a[3][leaf]))


def tree_bounds_exact(arrays, tris) -> bool:
    """Whether a builder's arrays (bbox_min, bbox_max, first, count, miss,
    order) over triangles (v0, e1, e2) form a skip-link tree whose boxes
    are exact: `order` a permutation, the leaves (1-4 triangles) covering
    it in DFS order, each leaf's box the bound of its triangles, each inner
    node's the bound of its children (i + 1 and miss[i + 1]), and each
    miss link the node after the subtree."""
    bmin, bmax, first, count, miss, order = arrays
    v0, e1, e2 = tris
    n, t = first.shape[0], order.shape[0]
    if not np.array_equal(np.sort(order), np.arange(t)):
        return False
    leaf = np.flatnonzero(first >= 0)
    inner = np.flatnonzero(first < 0)
    starts = np.concatenate([[0], np.cumsum(count[leaf])[:-1]])
    if (not np.array_equal(first[leaf], starts) or count[leaf].sum() != t
            or count[leaf].min() < 1 or count[leaf].max() > 4):
        return False
    p = np.stack([v0, v0 + e1, v0 + e2])[:, order]
    right = miss[inner + 1]
    return bool(
        np.array_equal(np.minimum.reduceat(p.min(0), starts), bmin[leaf])
        and np.array_equal(np.maximum.reduceat(p.max(0), starts),
                           bmax[leaf])
        and np.array_equal(np.minimum(bmin[inner + 1], bmin[right]),
                           bmin[inner])
        and np.array_equal(np.maximum(bmax[inner + 1], bmax[right]),
                           bmax[inner])
        and np.array_equal(miss[leaf], leaf + 1)
        and np.array_equal(miss[inner], miss[right]) and miss[0] == n)


def dense_phases(card: str) -> dict:
    """Phases 26-28 on the dense Disney scene: the build, timed by stage,
    its tree checked exact, and the plain builder held to the native one
    built without fused multiply-adds; both kernels held to
    the plain walk on every query of a 64x64, AA 3 frame on the global
    path, and timed there (the `dense` shape); the frame at its own
    options through the kernels, one profiled tile, and a 16x16 frame on
    the card and on the CPU. Returns what the JSON line reads: per kernel
    the compare results, the times and bound of the shape, and the frame's
    launches."""
    from rlshaders_tpu_torch.accel import bvh, native
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build
    from tools.make_dense_disney import dense_nodes

    # ---- phase 26: the build ----
    t0 = time.perf_counter()
    lib = native.build()
    t1 = time.perf_counter()
    nodes = dense_nodes(DENSE_AROUND)
    t2 = time.perf_counter()
    scene = build(nodes)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    accel = tracemod.build(scene.geometry)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    g = scene.geometry
    host = [x.cpu().numpy() for x in (g.v0, g.e1, g.e2)]
    t5 = time.perf_counter()
    arrays = native.build_arrays(*host)
    t6 = time.perf_counter()
    kernels.pack(accel.tree, accel.tris)
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    for f, a in zip(bvh.BVH._fields, arrays):
        if not np.array_equal(getattr(accel.tree, f).cpu().numpy(), a):
            raise AssertionError(f"[26] the accel's {f} is not the native "
                                 f"builder's")
    if not tree_bounds_exact(arrays, host):
        raise AssertionError("[26] the dense tree's boxes or links are wrong")
    n_tris, n_nodes = accel.tree.tri_order.shape[0], accel.tree.first.shape[0]
    log(f"[26] dense Disney scene: {n_tris} triangles, {n_nodes} nodes, "
        f"tables {table_bytes(accel)} B ({accel.packed.path} path; room "
        f"{kernels.TABLE_ROOM} B)")
    log(f"[26] seconds: native builder compiled {t1 - t0:.3f} ({lib}), "
        f"node list {t2 - t1:.3f}, scene build on {g.v0.device} "
        f"{t3 - t2:.3f}, trace.build {t4 - t3:.3f} (of which: host copy "
        f"{t5 - t4:.3f}, native BVH build {t6 - t5:.3f}, pack "
        f"{t7 - t6:.3f}, measured again alone)")
    if accel.packed.path != "global":
        raise AssertionError(f"the dense scene took {accel.packed.path}, "
                             f"expected the global path")
    # the plain builder equals the native one compiled without fused
    # multiply-adds (EXACT_FLAGS); the path's library (the JAX module's
    # flags) may fuse the SAH cost and move near-tied splits
    small = build(dense_nodes(DENSE_SMALL), device="cpu").geometry
    ball = (g.mesh_id == scene.mesh_names.index("ball_default")).cpu()
    for tag, tris in (
            (f"{DENSE_SMALL} x {DENSE_SMALL // 2}-quad copy",
             [x.numpy() for x in (small.v0, small.e1, small.e2)]),
            ("ball_default", [h[ball.numpy()] for h in host])):
        t1 = time.perf_counter()
        nat = native.build_arrays(*tris)
        t2 = time.perf_counter()
        plain = bvh.build_arrays(*tris)
        t3 = time.perf_counter()
        exact = native.build_arrays(*tris, flags=native.EXACT_FLAGS)
        log(f"[26] {tag}: {tris[0].shape[0]} triangles; native "
            f"{t2 - t1:.3f} s, plain {t3 - t2:.3f} s "
            f"({(t3 - t2) / (t2 - t1):.0f}x; host); nodes: native "
            f"{nat[0].shape[0]}, without fused multiply-adds "
            f"{exact[0].shape[0]}, plain {plain[0].shape[0]}; the native "
            f"tree's nodes and leaf sets equal the plain one's: "
            f"{same_nodes_and_leaves(nat, plain)}; the leaf orders of the "
            f"tree without fused multiply-adds and the plain one differ at "
            f"{int((exact[5] != plain[5]).sum())} of {plain[5].size} "
            f"positions")
        if not same_nodes_and_leaves(exact, plain):
            raise AssertionError(f"[26] the plain tree of the {tag} is not "
                                 f"the native builder's without fused "
                                 f"multiply-adds")
        if not tree_bounds_exact(nat, tris):
            raise AssertionError(f"[26] the native tree of the {tag} has "
                                 f"wrong boxes or links")
    del small, host, arrays
    log(f"[26] phase {time.perf_counter() - t0:.1f} s")

    # ---- phase 27: every query of a 64x64, AA 3 frame ----
    res, times, bounds = check_shape("27", "dense", scene, accel, DENSE_AA,
                                     DENSE_CHECK)
    took = path_launches(kernels)
    if set(took) != {"global"}:
        raise AssertionError(f"the dense frame's launches took {took}")

    # ---- phase 28: the frame at its own options ----
    t0 = time.perf_counter()
    reset(kernels)
    out, dt = barred_render(wavefront.render, bvh, scene, accel)
    launches = launched(kernels)
    took = path_launches(kernels)
    o = scene.options
    check_planes(out, o.xres)
    check_launched(launches, "the dense render")
    if set(took) != {"global"}:
        raise AssertionError(f"the dense frame's launches took {took}")
    if not float(out["indirect_specular"].mean()) > 0.0:
        raise AssertionError("the indirect_specular AOV is black")
    stats = out["__stats__"]
    rays = stats["nearest_rays"] + stats["shadow_rays"]
    log(f"[28] dense {o.xres}x{o.yres} AA {o.aa_samples}: {dt:.4f} s/frame, "
        f"mean RGB {float(out['RGBA'].mean()):.6f}, all planes finite, "
        f"launches {launches}, by table path {took}, nearest rays "
        f"{stats['nearest_rays']}, shadow rays {stats['shadow_rays']}, "
        f"{rays / dt / 1e6:.3f} Mrays/s (nearest+shadow); {card}")
    del out
    profile_frame(wavefront, "28", scene, accel, aa_samples=DENSE_AA,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    t1 = time.perf_counter()
    cscene = build(nodes, device="cpu")
    cpu = (cscene, tracemod.build(cscene.geometry))
    log(f"[28] the CPU scene and accel built in "
        f"{time.perf_counter() - t1:.1f} s")
    cuda_vs_cpu(wavefront, "28", {"cuda": (scene, accel), "cpu": cpu},
                (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=1, xres=DENSE_CPU,
                yres=DENSE_CPU)
    log(f"[28] phase {time.perf_counter() - t0:.1f} s")
    return {"compare": res, "times": times, "bounds": bounds,
            "launches": launches}


@contextlib.contextmanager
def plain_draws(rng):
    """core/rng.py's int64 tensor code for draws on the card, inside the
    block (the kernels' plain version)."""
    real = rng._on_card
    rng._on_card = lambda device: False
    try:
        yield
    finally:
        rng._on_card = real


def differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two draws (same device, dtype and shape) whose bits
    differ."""
    if a.dtype != torch.int64:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def rng_draws(rng, dev) -> list:
    """Every public draw of core/rng.py at a frame512 tile's shapes: (name,
    kernel, draw, bytes read and written, operations). The tile's own
    draws (RNG_TILE) come first; the rest are the other draws and layouts
    the main path and the SSS stage make, at the tile's lanes."""
    n = RNG_LANES
    key = rng.fold(rng.PRNGKey(RNG_SEED), 1000, 3)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    pix = (lane // (RNG_AA * RNG_AA)).to(torch.int32)
    aa = (lane % (RNG_AA * RNG_AA)).to(torch.int32)
    # sample indices across the uint32 range, past sobol_d1's 16 bits
    idx = (lane * 2654435761 + RNG_SEED) & 0xFFFFFFFF
    seeds = (lane * 0x9E3779B9 ^ RNG_SALT) & 0xFFFFFFFF
    col = torch.arange(RNG_COLUMNS, dtype=torch.int64, device=dev)
    purposes = ((RNG_PURPOSE * 0x1003) & 0xFFFFFFFF) ^ (0x10007 + col)
    tf, ss, sa = RNG_KERNELS
    s = RNG_S
    sides = RNG_AA              # a stratified draw's s: no power of two
    return [
        ("camera_uniform", tf, lambda: rng.uniform(
            key, (n // (RNG_AA * RNG_AA), RNG_AA * RNG_AA, 2), dev),
         8 * n, 2 * n * RNG_OPS["uniform"]),
        ("uniform2", tf, lambda: rng.uniform2(key, (s * n,), dev),
         8 * s * n, 2 * s * n * RNG_OPS["uniform"]),
        ("stratified2_flat", tf, lambda: rng.stratified2_flat(
            key, s * n, 1, dev),
         8 * s * n, 2 * s * n * RNG_OPS["stratified2_flat"]),
        ("sobol2_flat", ss, lambda: rng.sobol2_flat(
            pix, aa, s, RNG_PURPOSE, RNG_SALT),
         8 * s * n + 8 * n, s * n * RNG_OPS["sobol_stream"]),
        ("bits", tf, lambda: rng.bits(key, (n,), dev),
         8 * n, n * RNG_OPS["bits"]),
        ("stratified2", tf, lambda: rng.stratified2(
            key, (n // (sides * sides),), sides, dev),
         8 * n, 2 * n * RNG_OPS["stratified2"]),
        ("stratified2_flat_s3", tf, lambda: rng.stratified2_flat(
            key, n // (sides * sides), sides, dev),
         8 * n, 2 * n * RNG_OPS["stratified2_flat"]),
        ("sobol2_rep", ss, lambda: rng.sobol2_rep(
            pix, aa, s, RNG_PURPOSE, RNG_SALT),
         8 * s * n + 8 * n, s * n * RNG_OPS["sobol_stream"]),
        ("sobol2_at", sa, lambda: rng.sobol2_at(
            pix, idx, RNG_PURPOSE, RNG_SALT),
         8 * n + 12 * n, n * RNG_OPS["sobol_at"]),
        ("sobol2_at_columns", sa, lambda: rng.sobol2_at(
            pix, idx, purposes, RNG_SALT),
         8 * RNG_COLUMNS * n + 12 * n + 8 * RNG_COLUMNS,
         RNG_COLUMNS * n * RNG_OPS["sobol_at_columns"]),
        ("sobol2", sa, lambda: rng.sobol2(idx, seeds),
         8 * n + 16 * n, n * RNG_OPS["sobol_at_seeded"]),
    ]


def sass_counts(lib: str) -> dict:
    """Instructions of each draw kernel in the library's SASS
    (cuobjdump), a static count over all of a kernel's branches; {} where
    cuobjdump is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    run = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True)
    if run.returncode != 0:
        return {}
    text = run.stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((k for k in ("threefry_kernel", "sobol_stream_kernel",
                                     "sobol_at_kernel") if k in fn), None)
            if name:
                out[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line and \
                line.split("*/", 1)[1].strip():
            out[name] += 1
    return out


def rng_phase(card: str) -> dict:
    """Phase 49: the draws' kernels. Every public draw of core/rng.py on
    the card at a frame512 tile's shapes (rng_draws), each one launch of
    its kernel and bit-equal to the plain int64 code on the same inputs on
    the CPU (the values that differ from that code run on the card are
    counted: torch's CUDA division by a scalar multiplies by its
    reciprocal, so a stratified draw whose s is no power of two differs
    there), timed (device_ms, call_ms, plain_ms on the card) beside its
    bound; the disney_grid
    frame512 frame (portbench's cell) with the launch counts reset and the
    counters on: the launches per kernel equal to RNG_TILE's mix and every
    value drawn by a kernel; its tile through `render_tile_at` equal bit
    for bit to the same tile with the plain draws. Returns per kernel its
    shapes, mismatches and the tile's numbers, and the frame's launches."""
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.core import rng, tracer
    from rlshaders_tpu_torch.integrator import camera as cameramod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.ops import rng as rng_kernels
    from rlshaders_tpu_torch.scene.build import build

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    per = {k: {"shapes": {}, "mismatches": 0, "max_abs_err": 0.0}
           for k in RNG_KERNELS}
    cpu = torch.device("cpu")
    for (name, kern, draw, nbytes, ops), ref in zip(
            rng_draws(rng, dev), (d[2] for d in rng_draws(rng, cpu))):
        before = dict(rng_kernels.LAUNCHES)
        got = draw()
        torch.cuda.synchronize()
        made = {k: n - before[k] for k, n in rng_kernels.LAUNCHES.items()}
        if made != {k: int(k == kern) for k in made}:
            raise AssertionError(f"[49] {name} launched {made}, expected "
                                 f"one {kern}")
        want = ref()
        with plain_draws(rng):
            on_card = draw()
            pm = cuda_ms(draw, 1)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"[49] {name}: {got.dtype} "
                                 f"{tuple(got.shape)}, plain {want.dtype} "
                                 f"{tuple(want.shape)}")
        bad = differ(got.cpu(), want)
        bad_card = differ(got, on_card)
        err = float((got.cpu().double() - want.double()).abs().max())
        values = got.numel()
        del got, want, on_card
        dm = device_ms(draw, RNG_REPS)
        cm = cuda_ms(draw, RNG_REPS)
        byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops / ISSUE_OPS_PER_S * 1e3
        b = max(byte_ms, op_ms)
        row = per[kern]
        row["mismatches"] += bad
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"][name] = {
            "launches": 1, "values": values, "device_ms": dm,
            "call_ms": cm, "plain_ms": pm,
            "bound_ms": b, "bound_by": "bytes" if byte_ms >= op_ms
            else "operations", "byte_ms": byte_ms, "op_ms": op_ms,
            "mismatches": bad, "differ_plain_card": bad_card}
        log(f"[49] {name} ({kern}): {bad} mismatches against the plain "
            f"draw on the CPU, max abs err {err:.3g}; {bad_card} values "
            f"differ from the plain draw on the card; device {dm:.4f} ms, "
            f"call "
            f"{cm:.4f} ms, plain {pm:.4f} ms; bound {b:.4f} ms by "
            f"{row['shapes'][name]['bound_by']} (bytes {nbytes} B "
            f"{byte_ms:.4f} ms, operations {ops} {op_ms:.4f} ms), share "
            f"of device time {b / dm:.4f}")
        if bad:
            raise AssertionError(f"[49] {name} disagrees with the plain "
                                 f"draw")
    for k, row in per.items():
        tile = [(row["shapes"][n], c) for n, c in RNG_TILE.items()
                if n in row["shapes"]]
        row["tile"] = {
            f: sum(sh[f] * c for sh, c in tile)
            for f in ("launches", "values", "device_ms", "call_ms",
                      "plain_ms", "bound_ms", "byte_ms", "op_ms")}
        if tile:
            t = row["tile"]
            log(f"[49] {k}: the tile's {t['launches']} draws, device "
                f"{t['device_ms']:.4f} ms, call {t['call_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} "
                f"ms (bytes {t['byte_ms']:.4f}, operations "
                f"{t['op_ms']:.4f}), share {t['bound_ms'] / t['device_ms']:.4f}")
    log(f"[49] instructions a kernel in the SASS (static, every branch): "
        f"{sass_counts(kernels.build())}; {card}")

    # ---- the frame512 frame: launches, counters, the tile held equal ----
    scene = build(RNG_SCENE)
    accel = tracemod.build(scene.geometry)
    kw = dict(seed=RNG_SEED, tile_pixels=RNG_RES * RNG_RES,
              aa_samples=RNG_AA, xres=RNG_RES, yres=RNG_RES)
    wavefront.render_tiles(scene, accel, **kw)
    tracer.take()
    reset(kernels)
    with tracer.enabled(counters=True):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wavefront.render_tiles(scene, accel, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        _, counters = tracer.take()
    launches = launched(kernels)
    want = {k: 0 for k in RNG_KERNELS}
    for n, c in RNG_TILE.items():
        want[next(k for k, r in per.items() if n in r["shapes"])] += c
    got = {k: launches[k] for k in RNG_KERNELS}
    values = sum(r["tile"]["values"] for r in per.values())
    share = counters["rng_kernel_values"] / max(counters["rng_values"], 1)
    log(f"[49] disney_grid {RNG_RES}x{RNG_RES} AA {RNG_AA}, one tile: "
        f"{dt:.4f} s/frame (counters on), launches {launches}, values "
        f"drawn {counters['rng_values']} (the draws above {values}), by "
        f"the kernels {share:.4f}")
    if got != want or counters["rng_values"] != values or share != 1.0:
        raise AssertionError(f"[49] the frame's draws {got} (expected "
                             f"{want}), values {counters['rng_values']} "
                             f"(expected {values}), kernel share {share}")
    key = rng.stream(scene.options.aa_seed + RNG_SEED)
    rays = cameramod.generate(scene.camera, rng.fold(key, 77), RNG_AA,
                              RNG_RES, RNG_RES)
    tiles = []
    for plain in (False, True):
        tr = wavefront.TileRenderer(scene, accel, RNG_AA, xres=RNG_RES)
        with plain_draws(rng) if plain else contextlib.nullcontext():
            rgb, aovs = tr.render_tile_at(rays, 0, RNG_LANES,
                                          rng.fold(key, 1000))
        tiles.append({"RGBA": rgb, **aovs})
    bad = {k: int((v.view(torch.int32)
                   != tiles[1][k].view(torch.int32)).sum())
           for k, v in tiles[0].items()}
    log(f"[49] the tile ({RNG_LANES} lanes) through render_tile_at with "
        f"the kernels' and the plain draws: values that differ by plane "
        f"{bad}")
    if any(bad.values()) or not float(tiles[0]["RGBA"].abs().sum()) > 0.0:
        raise AssertionError("[49] the tile differs with the plain draws")
    del tiles, rays
    log(f"[49] phase {time.perf_counter() - t0:.1f} s; {card}")
    return {"kernels": per, "launches": launches}


class _LobeStop(Exception):
    """Ends a render once phase 50 holds the call it waits for."""


def lobe_ordered(x: torch.Tensor) -> torch.Tensor:
    i = x.view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def lobe_diff(got, want) -> tuple:
    """(lanes whose outputs differ, their largest ulp distance, lanes
    apart by more than 4 ulps and 1e-4 of max(1, |eager value|)) of a lobe
    call on the kernel and on the eager path (-0 equals +0, NaN NaN)."""
    def rows(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for a in x for t in rows(a)]

    g, w = torch.stack(rows(got)), torch.stack(rows(want))
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    ulps = torch.where(same, 0, (lobe_ordered(g) - lobe_ordered(w)).abs())
    far = ((ulps > 4) & ((g - w).abs()
                         > 1e-4 * torch.clamp_min(w.abs(), 1.0))).any(0)
    ulps = ulps.amax(0)
    if ulps.numel() == 0:
        return 0, 0, 0
    return int((ulps > 0).sum()), int(ulps.max()), int(far.sum())


@contextlib.contextmanager
def eager_lobes(dispatch):
    """models/dispatch.py's eager lobes on the card inside the block (the
    kernels' plain version)."""
    real = dispatch._on_card
    dispatch._on_card = lambda wo: False
    try:
        yield
    finally:
        dispatch._on_card = real


@contextlib.contextmanager
def held_lobes(dispatch, per: dict, keep: dict, stop=None):
    """Inside the block every lobe call runs its kernel, then the eager
    code on the same inputs: per[kernel] counts calls, lanes, differing
    lanes and their largest ulp distance; keep[entry] holds the arguments
    of the entry's largest call. `stop(entry, lanes)` true ends the render
    (_LobeStop) after that call."""
    reals = {e: getattr(dispatch, e) for e in LOBE_ENTRIES}

    def held(entry):
        def call(*args):
            got = reals[entry](*args)
            with eager_lobes(dispatch):
                want = reals[entry](*args)
            lanes = args[1].x.shape[0]
            differ, ulps, far = lobe_diff(got, want)
            row = per[f"rls_bsdf_{entry}"]
            row["calls"] += 1
            row["lanes"] += lanes
            row["differ"] += differ
            row["far"] += far
            row["max_ulps"] = max(row["max_ulps"], ulps)
            if lanes >= keep.get(entry, (0,))[0]:
                keep[entry] = (lanes, args)
            del want
            if stop is not None and stop(entry, lanes):
                raise _LobeStop
            return got
        return call

    try:
        for e in LOBE_ENTRIES:
            setattr(dispatch, e, held(e))
        yield
    finally:
        for e, f in reals.items():
            setattr(dispatch, e, f)


def lobe_bound(entry: str, m, lanes: int) -> dict:
    """The bound of one call of `entry` over its lanes (LOBE_BYTES and
    LOBE_OPS by branch, the branches counted on the card)."""
    from rlshaders_tpu_torch.scene.build import MAT_DISNEY, MAT_SKIN

    count = {"disney": 0, "skin": 0}
    if entry != "sample_diffuse":
        if m.dsy is not None:
            count["disney"] = int((m.mtype == MAT_DISNEY).sum())
        if m.ggx2 is not None:
            count["skin"] = int((m.mtype == MAT_SKIN).sum())
    count["other"] = lanes - count["disney"] - count["skin"]
    bb, ops = LOBE_BYTES[entry], LOBE_OPS[entry]
    typed = entry != "sample_diffuse" and (m.dsy is not None
                                           or m.ggx2 is not None)
    nbytes = lanes * (bb["lane"] + (bb["mtype"] if typed else 0)) + sum(
        c * bb[k] for k, c in count.items())
    nops = sum(c * ops[k] for k, c in count.items())
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = nops / ISSUE_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": nops, "byte_ms": byte_ms, "op_ms": op_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "branches": count}


def time_lobe(dispatch, kernels_mod, tag: str, entry: str, args) -> dict:
    """One kept call timed: device_ms (the kernel in a CUDA graph),
    call_ms (dispatch's entry point, host packing included), plain_ms (the
    eager lobes on the card), beside its bound."""
    m, lanes = args[0], args[1].x.shape[0]
    if entry == "sample_diffuse":
        kern = partial(kernels_mod.sample_diffuse, args[2], args[3])
    else:
        kern = partial(getattr(kernels_mod, entry), *args)
    fn = getattr(dispatch, entry)
    dm = device_ms(kern, LOBE_REPS)
    cm = cuda_ms(lambda: fn(*args), LOBE_REPS)
    with eager_lobes(dispatch):
        pm = cuda_ms(lambda: fn(*args), 1)
    b = lobe_bound(entry, m, lanes)
    row = {"lanes": lanes, "device_ms": dm, "call_ms": cm, "plain_ms": pm,
           **b}
    log(f"[50] {tag} {entry} (rls_bsdf_{entry}), {lanes} lanes "
        f"{b['branches']}: device {dm:.4f} ms, call {cm:.4f} ms, plain "
        f"{pm:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"(bytes {b['bytes']} {b['byte_ms']:.4f} ms, operations "
        f"{b['ops']} {b['op_ms']:.4f} ms), share of device time "
        f"{b['bound_ms'] / dm:.4f}")
    return row


def lobe_phase(card: str) -> dict:
    """Phase 50: the lobes' kernels. The disney_grid frame512 frame (one
    tile, portbench's disney.frame512 cell) with every lobe call run by
    its kernel and by the eager code on the same inputs (lanes that differ
    counted with their largest ulp distance), the launch counts reset and
    the counters on: one launch a call and every lobe lane handled by a
    kernel; then the glass cell's scene up to its first refraction family
    (9,437,184 lanes), held the same way. The largest call of each entry
    point (the frame's 9,437,184-lane columns and families, the glass
    family) timed beside its bound. Returns per kernel its numbers and the
    frames' launches."""
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.core import tracer
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.models import dispatch
    from rlshaders_tpu_torch.ops import bsdf as lobe_kernels
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build

    t0 = time.perf_counter()
    per = {k: {"calls": 0, "lanes": 0, "differ": 0, "far": 0,
               "max_ulps": 0, "shapes": {}} for k in LOBE_KERNELS}
    scene = build(RNG_SCENE)
    accel = tracemod.build(scene.geometry)
    kw = dict(seed=RNG_SEED + 50, tile_pixels=RNG_RES * RNG_RES,
              aa_samples=RNG_AA, xres=RNG_RES, yres=RNG_RES)
    wavefront.render_tiles(scene, accel, **kw)
    tracer.take()
    reset(kernels)
    keep = {}
    with held_lobes(dispatch, per, keep), tracer.enabled(counters=True):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wavefront.render_tiles(scene, accel, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        _, counters = tracer.take()
    launches = launched(kernels)
    calls = {k: r["calls"] for k, r in per.items()}
    share = counters["bsdf_kernel_lanes"] / max(counters["bsdf_lanes"], 1)
    lanes = sum(r["lanes"] for r in per.values())
    log(f"[50] disney_grid {RNG_RES}x{RNG_RES} AA {RNG_AA}, one tile, every "
        f"lobe call held to the eager lobes: {dt:.4f} s; calls {calls}, "
        f"launches {({k: launches[k] for k in LOBE_KERNELS})}, lanes "
        f"{counters['bsdf_lanes']} (the calls' {lanes}), by the kernels "
        f"{share:.4f}")
    if ({k: launches[k] for k in LOBE_KERNELS} != calls or share != 1.0
            or counters["bsdf_lanes"] != lanes):
        raise AssertionError(f"[50] the frame's lobe launches "
                             f"{launches} (calls {calls}), kernel share "
                             f"{share}")
    for entry, (n, args) in sorted(keep.items()):
        per[f"rls_bsdf_{entry}"]["shapes"][f"frame512_{entry}"] = time_lobe(
            dispatch, lobe_kernels, "frame512", entry, args)
    keep.clear()
    del scene, accel

    # ---- glass: up to the first refraction family ----
    scene = build(LOBE_GLASS)
    accel = tracemod.build(scene.geometry)
    reset(kernels)
    try:
        with held_lobes(dispatch, per, keep, lambda e, n: (
                e == "sample_refract" and n == LOBE_FAMILY)):
            wavefront.render_tiles(scene, accel, **kw)
        raise AssertionError(f"[50] the glass frame made no refraction "
                             f"family of {LOBE_FAMILY} lanes")
    except _LobeStop:
        pass
    torch.cuda.synchronize()
    glass_launches = launched(kernels)
    n, args = keep["sample_refract"]
    per["rls_bsdf_sample_refract"]["shapes"]["glass_family"] = time_lobe(
        dispatch, lobe_kernels, "glass", "sample_refract", args)
    keep.clear()
    for k, r in per.items():
        log(f"[50] {k}: {r['calls']} calls, {r['lanes']} lanes, {r['differ']} "
            f"differ from the eager lobes on the card, at most "
            f"{r['max_ulps']} ulps apart, {r['far']} beyond 4 ulps and "
            f"1e-4 relative")
        if r["far"] > LOBE_FAR_SHARE * r["lanes"]:
            raise AssertionError(f"[50] {k} is far from the eager lobes "
                                 f"on {r['far']} of {r['lanes']} lanes")
    log(f"[50] phase {time.perf_counter() - t0:.1f} s; {card}")
    return {"kernels": per, "launches": launches,
            "glass_launches": glass_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    from rlshaders_tpu_torch.accel import bvh
    from rlshaders_tpu_torch.accel import trace as tracemod
    from rlshaders_tpu_torch.core import rng
    from rlshaders_tpu_torch.integrator import camera as cameramod
    from rlshaders_tpu_torch.integrator import wavefront
    from rlshaders_tpu_torch.ops import intersect as kernels
    from rlshaders_tpu_torch.scene.build import build, build_text
    from rlshaders_tpu_torch.scene.demo import demo_scene

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name} | nvidia-smi: {card} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"[2] built {lib} in {time.perf_counter() - t0:.2f} s")

    # ---- demo: kernels vs the plain walk on every query of a frame ----
    t0 = time.perf_counter()
    scene, accel = demo_scene(skin=False)
    calls = capture_queries(scene, accel, wavefront, tracemod,
                            aa_samples=AA, xres=SIZE, yres=SIZE)
    reset(kernels)
    frame = compare(accel, calls, bvh, kernels)
    rand = compare(accel, random_queries(accel, 100_000, 7), bvh, kernels)
    log(f"[3] demo tables {table_bytes(accel)} B: launches by table path "
        f"{path_launches(kernels)}")
    for k in REPLACES:
        live = sum(int((c[3] > 0).sum()) for c in calls if c[0] == k)
        log(f"[3] {k}: frame queries {frame[k][1]} rays ({live} live, the "
            f"rest t_max <= 0), {frame[k][0]} "
            f"mismatches; random queries {rand[k][1]} rays, {rand[k][0]} "
            f"mismatches; max abs err {max(frame[k][2], rand[k][2]):.3g}")
        if frame[k][0] or rand[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version")
    sacc = soup_accel(tracemod, SOUP)
    reset(kernels)
    soup = compare(sacc, random_queries(sacc, 20_000, 11), bvh, kernels)
    took = path_launches(kernels)
    log(f"[3] {SOUP}-triangle soup, tables {table_bytes(sacc)} B: launches "
        f"by table path {took}; " + "; ".join(
            f"{k} {soup[k][1]} rays, {soup[k][0]} mismatches"
            for k in REPLACES))
    if set(took) != {"global"}:
        raise AssertionError(f"the {SOUP}-triangle soup took {took}, "
                             f"expected the global path")
    if any(soup[k][0] for k in REPLACES):
        raise AssertionError(f"a kernel disagrees with its plain version "
                             f"on the {SOUP}-triangle soup")
    del sacc
    times = time_kernels(accel, calls, bvh, kernels)
    demo_bound = {}
    for k, (dm, cm, pm, r, n) in times.items():
        b = demo_bound[k] = bound(k, r, frame[k][3], accel)
        log(f"[3] {k}: all {r} rays of the frame's {n} queries: device "
            f"{dm:.4f} ms, call {cm:.4f} ms ({dm / n * 1e3:.2f} / "
            f"{cm / n * 1e3:.2f} us per launch), plain {pm:.4f} ms; walk "
            f"{walk_counts(frame[k][3])}; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} (bytes {b['byte_ms']:.4f} ms, operations "
            f"{b['op_ms']:.4f} ms), "
            f"share of device time {b['bound_ms'] / dm:.4f}")
    del calls
    log(f"[3] phase {time.perf_counter() - t0:.1f} s")

    # ---- the demo path: a timed 256x256 frame through the kernels ----
    reset(kernels)
    out, dt = barred_render(wavefront.render, bvh, scene, accel,
                            aa_samples=AA, xres=SIZE, yres=SIZE)
    demo_launches = launched(kernels)
    check_planes(out, SIZE)
    check_launched(demo_launches, "the demo render")
    stats = out["__stats__"]
    rays = stats["nearest_rays"] + stats["shadow_rays"]
    log(f"[4] {SIZE}x{SIZE} AA {AA}: {dt:.4f} s/frame, mean RGB "
        f"{float(out['RGBA'].mean()):.6f}, launches {demo_launches}, by "
        f"table path {path_launches(kernels)}, "
        f"nearest rays {stats['nearest_rays']}, shadow rays "
        f"{stats['shadow_rays']}, {rays / dt / 1e6:.3f} Mrays/s "
        f"(nearest+shadow)")

    t0 = time.perf_counter()
    cuda_vs_cpu(wavefront, "5", {
        "cuda": (scene, accel), "cpu": demo_scene(skin=False, device="cpu")},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=32, yres=32)
    log(f"[5] phase {time.perf_counter() - t0:.1f} s")

    # ---- glass: every query of a 48x48 frame with roulette-dead lanes, at
    # a refraction depth of GLASS_CHECK_DEPTH (its launches, not its rays,
    # set the plain walk's time) ----
    t0 = time.perf_counter()
    gscene = build(GLASS)
    gaccel = tracemod.build(gscene.geometry)
    with open(GLASS) as f:
        shallow = f.read().replace(
            "GI_refraction_depth 3", f"GI_refraction_depth {GLASS_CHECK_DEPTH}")
    if f"GI_refraction_depth {GLASS_CHECK_DEPTH}" not in shallow:
        raise AssertionError(f"{GLASS} sets no GI_refraction_depth 3")
    gshallow = build_text(shallow, base_dir=os.path.dirname(GLASS))
    calls = capture_queries(
        gshallow, gaccel, wavefront, tracemod, aa_samples=GLASS_AA,
        xres=GLASS_CHECK, yres=GLASS_CHECK, rr_refr_start=GLASS_RR)
    reset(kernels)
    glass = compare(gaccel, calls, bvh, kernels)
    log(f"[6] captured and compared in {time.perf_counter() - t0:.1f} s; "
        f"glass tables {table_bytes(gaccel)} B: launches by table path "
        f"{path_launches(kernels)}")
    for k in REPLACES:
        log(f"[6] {k}: {glass[k][1]} rays in {query_mix(calls, k)}, "
            f"{glass[k][0]} mismatches, max abs err {glass[k][2]:.3g}")
        if glass[k][0]:
            raise AssertionError(f"{k} disagrees with its plain version on "
                                 f"the glass frame")
        dl = dead_lanes(calls, k)
        log(f"[6] {k} dead lanes: {dl['no_live']} of {dl['launches']} "
            f"launches have no live lane; live share {dl['live'] / dl['rays']:.4f}; "
            f"32-lane groups with a live lane {dl['live_groups']} of "
            f"{dl['groups']} ({dl['live_groups'] / dl['groups']:.4f}), live "
            f"share inside them "
            f"{dl['live'] / max(32 * dl['live_groups'], 1):.4f}")
    kinds = query_kinds(calls)
    log(f"[6] {GLASS_CHECK}x{GLASS_CHECK} frame's query kinds (both "
        f"kernels): {kinds}")
    missing = [k for k, v in kinds.items() if not v]
    if missing:
        raise AssertionError(f"[6] the glass check frame holds no {missing}")
    gtimes, glass_bound = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, _ = pair(k, kernels, bvh, gaccel)
        dm, cm = kernel_ms(kern, mine, 3)
        prof = profiled_ms(partial(run_all, kern, mine),
                           k[len("rls_"):] + "_kernel")
        r = sum(c[0].shape[0] for c in mine)
        gtimes[k] = (dm, cm, None, r, len(mine))
        b = glass_bound[k] = bound(k, r, glass[k][3], gaccel)
        walks = glass[k][3]
        log(f"[6] {k}: all {r} rays of the glass frame's {len(mine)} "
            f"queries: device {dm:.4f} ms (torch.profiler's sum of the "
            f"kernel's launches {prof:.4f} ms), call {cm:.4f} ms "
            f"({dm / len(mine) * 1e3:.2f} / {cm / len(mine) * 1e3:.2f} us per "
            f"launch); walk {walk_counts(walks)}: per live ray "
            f"{walks['boxes'] / walks['rays']:.2f} slab tests; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), share "
            f"of device time {b['bound_ms'] / dm:.4f}")
    del calls
    profile_frame(wavefront, "6", gscene, gaccel, aa_samples=GLASS_AA,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    log(f"[6] phase {time.perf_counter() - t0:.1f} s")

    # ---- the glass path: a timed 256x256, AA 3 frame ----
    reset(kernels)
    gout, gdt = barred_render(wavefront.render, bvh, gscene, gaccel,
                              aa_samples=GLASS_AA, xres=SIZE, yres=SIZE)
    glass_launches = launched(kernels)
    check_planes(gout, SIZE)
    if glass_launches["rls_nearest"] <= 0:
        raise AssertionError("rls_nearest was not launched by the glass "
                             "render")
    refr = float(gout["refraction"].mean())
    if not refr > 0.0:
        raise AssertionError("the refraction AOV is black")
    gstats = gout["__stats__"]
    grays = gstats["nearest_rays"] + gstats["shadow_rays"]
    log(f"[7] glass {SIZE}x{SIZE} AA {GLASS_AA}: {gdt:.4f} s/frame, mean "
        f"RGB {float(gout['RGBA'].mean()):.6f}, refraction AOV mean "
        f"{refr:.6f}, all planes finite, launches {glass_launches}, by table "
        f"path {path_launches(kernels)}, "
        f"nearest rays {gstats['nearest_rays']} ({gstats['march_segments']} "
        f"shadow segments marched), shadow rays {gstats['shadow_rays']}, "
        f"{grays / gdt / 1e6:.3f} Mrays/s (nearest+shadow)")
    del gout

    # ---- j_walk: each kernel alone at the TPU tool's query shapes ----
    t0 = time.perf_counter()
    jsets = jwalk_rays(gscene, gaccel, tracemod, rng, cameramod)
    n = JWALK_RAYS
    tmax = torch.full((n,), 1e30, device=DEVICE)
    ex = torch.full((n,), -1, dtype=torch.int32, device=DEVICE)
    jwalk = {}
    for tag, (o, d) in jsets.items():
        for k in REPLACES:
            kern, walk = pair(k, kernels, bvh, gaccel)
            q = [(o, d, tmax, ex, 0xFF)]
            counts = {}
            walk(o, d, tmax, ex, 0xFF, counts=counts)
            dm, cm = kernel_ms(kern, q, 50)
            pms = cuda_ms(lambda: walk(o, d, tmax, ex, 0xFF), 1)
            b = bound(k, n, counts, gaccel)
            jwalk[(k, tag)] = (dm, cm, pms, b)
            log(f"[8] j_walk {tag} {k}: device {dm:.4f} ms "
                f"({n / dm / 1e3:.1f} Mrays/s), call {cm:.4f} ms, plain "
                f"{pms:.4f} ms; walk {walk_counts(counts)}; byte bound "
                f"{b['byte_ms']:.4f} ms, operation bound {b['op_ms']:.4f} "
                f"ms, share of the larger ({b['bound_by']}) of device time "
                f"{b['bound_ms'] / dm:.4f}")
    log(f"[8] phase {time.perf_counter() - t0:.1f} s")

    # ---- the glass frame on the card and on the CPU, at phase 6's
    # refraction depth ----
    t0 = time.perf_counter()
    cscene = build_text(shallow, device="cpu",
                        base_dir=os.path.dirname(GLASS))
    cuda_vs_cpu(wavefront, "9", {
        "cuda": (gshallow, gaccel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=GLASS_CPU,
        yres=GLASS_CPU)
    log(f"[9] phase {time.perf_counter() - t0:.1f} s")

    # ---- skin: every query of 64x64 frames of the SSS probe stage ----
    t0 = time.perf_counter()
    sscene = build(SKIN)
    saccel = tracemod.build(sscene.geometry)
    calls = capture_queries(sscene, saccel, wavefront, tracemod,
                            aa_samples=AA, xres=SKIN_CHECK, yres=SKIN_CHECK)
    dscene, daccel = demo_scene()
    dcalls = capture_queries(dscene, daccel, wavefront, tracemod,
                             aa_samples=AA, xres=SKIN_CHECK, yres=SKIN_CHECK)
    reset(kernels)
    skin = compare(saccel, calls, bvh, kernels)
    skin_demo = compare(daccel, dcalls, bvh, kernels)
    log(f"[10] captured and compared in {time.perf_counter() - t0:.1f} s; "
        f"skin tables {table_bytes(saccel)} B, demo tables "
        f"{table_bytes(daccel)} B: launches by table path "
        f"{path_launches(kernels)}")
    for tag, res, cl in (("skin", skin, calls), ("skin demo", skin_demo,
                                                   dcalls)):
        for k in REPLACES:
            dl = dead_lanes(cl, k)
            log(f"[10] {tag} {k}: {res[k][1]} rays in {query_mix(cl, k)}, "
                f"{res[k][0]} mismatches, max abs err {res[k][2]:.3g}; "
                f"{dl['no_live']} launches with no live lane, live share "
                f"{dl['live'] / dl['rays']:.4f}")
            if res[k][0]:
                raise AssertionError(f"{k} disagrees with its plain version "
                                     f"on the {tag} frame")
    del dcalls
    stimes, skin_bound = {}, {}
    for k in REPLACES:
        mine = [c[1:] for c in calls if c[0] == k]
        kern, walk = pair(k, kernels, bvh, saccel)
        pm = events_ms(lambda: run_all(walk, mine), 1)
        dm, cm = kernel_ms(kern, mine, 5)
        r = sum(c[0].shape[0] for c in mine)
        stimes[k] = (dm, cm, pm, r, len(mine))
        b = skin_bound[k] = bound(k, r, skin[k][3], saccel)
        log(f"[10] {k}: all {r} rays of the skin frame's {len(mine)} "
            f"queries: device {dm:.4f} ms, call {cm:.4f} ms "
            f"({dm / len(mine) * 1e3:.2f} / {cm / len(mine) * 1e3:.2f} us "
            f"per launch), plain {pm:.4f} ms; walk "
            f"{walk_counts(skin[k][3])}; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
            f"{b['byte_ms']:.4f} ms, operations {b['op_ms']:.4f} ms), share "
            f"of device time {b['bound_ms'] / dm:.4f}")
    del calls
    log(f"[10] phase {time.perf_counter() - t0:.1f} s")

    # ---- the skin path: skin_closeup.ass at its own options ----
    t0 = time.perf_counter()
    reset(kernels)
    sout, sdt = barred_render(wavefront.render, bvh, sscene, saccel)
    skin_launches = launched(kernels)
    so = sscene.options
    check_planes(sout, so.xres)
    check_launched(skin_launches, "the skin render")
    sss = float(sout["sss"].mean())
    if not sss > 0.0:
        raise AssertionError("the sss AOV is black")
    sstats = sout["__stats__"]
    srays = sstats["nearest_rays"] + sstats["shadow_rays"]
    log(f"[11] skin {so.xres}x{so.yres} AA {so.aa_samples}: {sdt:.4f} "
        f"s/frame, mean RGB {float(sout['RGBA'].mean()):.6f}, sss AOV mean "
        f"{sss:.6f}, all planes finite, launches {skin_launches}, by table "
        f"path {path_launches(kernels)}, nearest rays "
        f"{sstats['nearest_rays']}, shadow rays {sstats['shadow_rays']}, "
        f"{srays / sdt / 1e6:.3f} Mrays/s (nearest+shadow)")
    del sout
    profile_frame(wavefront, "11", sscene, saccel, aa_samples=AA,
                  xres=PROFILE_SIZE, yres=PROFILE_SIZE)
    log(f"[11] phase {time.perf_counter() - t0:.1f} s")

    # ---- the skin frame on the card and on the CPU ----
    t0 = time.perf_counter()
    cscene = build(SKIN, device="cpu")
    cuda_vs_cpu(wavefront, "12", {
        "cuda": (sscene, saccel),
        "cpu": (cscene, tracemod.build(cscene.geometry))},
        (PIX_TOL, PIX_FRAC, MEAN_RTOL), aa_samples=AA, xres=SKIN_CPU,
        yres=SKIN_CPU)
    log(f"[12] phase {time.perf_counter() - t0:.1f} s")

    dsy = scene_phases((13, 14, 15), DISNEY, DISNEY_AA, DISNEY_CHECK,
                       DISNEY_CPU, "disney", "indirect_specular")
    disney_step_phase(card)
    tex = scene_phases((17, 18, 19), TEXTURED, TEXTURED_AA, TEXTURED_CHECK,
                       TEXTURED_CPU, "textured", "direct_diffuse")
    clirun = cli_phase(card)
    tsets = trace_set_phase()
    suite_phase(clirun["golden"])
    mesh1 = mesh_world1_phase(card)
    mesh2 = mesh_world2_phase(card)
    jpeg_launches = jpeg_phase(card)
    dense = dense_phases(card)
    image_launches = image_phases(card)
    format_launches = format_phases(card)
    format_b_launches = format_b_phases(card)
    format_c_launches = format_c_phases(card)
    format_d_launches = format_d_phases(card)
    format_e_launches = format_e_phases(card)
    format_f_launches = format_f_phases(card)
    format_g_launches = format_g_phases(card)
    format_h_launches = format_h_phases(card)
    format_i_launches = format_i_phases(card)
    rngrun = rng_phase(card)
    lobes = lobe_phase(card)

    # the launches of each main-path run, by kernel
    runs = {"demo": [demo_launches], "glass": [glass_launches],
            "skin": [skin_launches], "disney": [dsy["launches"]],
            "textured": [tex["launches"]], "cli": [clirun["launches"]],
            "mesh": [mesh1, mesh2], "jpeg": [jpeg_launches],
            "dense": [dense["launches"]], "images": [image_launches],
            "formats": [format_launches], "formats_b": [format_b_launches],
            "formats_c": [format_c_launches],
            "formats_d": [format_d_launches],
            "formats_e": [format_e_launches],
            "formats_f": [format_f_launches],
            "formats_g": [format_g_launches],
            "formats_h": [format_h_launches],
            "formats_i": [format_i_launches],
            "frame512": [rngrun["launches"]],
            "lobes": [lobes["launches"], lobes["glass_launches"]]}

    def run_launches(k: str) -> dict:
        return {f"launches_{r}": sum(d.get(k, 0) for d in ds)
                for r, ds in runs.items()}

    entries = []
    for k in REPLACES:
        def shape(dm, cm, pm, b, launches):
            return {"launches": launches, "device_ms": dm, "call_ms": cm,
                    "plain_ms": pm, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"]}

        dm, cm, pm, _, nq = times[k]
        shapes = {"demo": shape(dm, cm, pm, demo_bound[k], nq)}
        dm, cm, pm, _, nq = gtimes[k]
        shapes["glass"] = shape(dm, cm, pm, glass_bound[k], nq)
        dm, cm, pm, _, nq = stimes[k]
        shapes["skin"] = shape(dm, cm, pm, skin_bound[k], nq)
        dm, cm, pm, _, nq = dsy["times"][k]
        shapes["disney"] = shape(dm, cm, pm, dsy["bounds"][k], nq)
        dm, cm, pm, _, nq = tex["times"][k]
        shapes["textured"] = shape(dm, cm, pm, tex["bounds"][k], nq)
        dm, cm, pm, _, nq = dense["times"][k]
        shapes["dense"] = shape(dm, cm, pm, dense["bounds"][k], nq)
        for tag, (_, tt, tb) in tsets.items():
            dm, cm, pm, _, nq = tt[k]
            shapes[f"trace_sets_{tag}"] = shape(dm, cm, pm, tb[k], nq)
        for tag in jsets:
            dm, cm, pm, b = jwalk[(k, tag)]
            shapes[f"jwalk_{tag}"] = shape(dm, cm, pm, b, 1)
        by_run = run_launches(k)
        entries.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k],
            "launches": sum(by_run.values()),
            "max_abs_err": max(frame[k][2], rand[k][2], glass[k][2],
                               soup[k][2], skin[k][2], skin_demo[k][2],
                               dsy["compare"][k][2], tex["compare"][k][2],
                               dense["compare"][k][2],
                               *(r[k][2] for r, _, _ in tsets.values())),
            "ms": times[k][1], "plain_ms": times[k][2],
            "bound_ms": demo_bound[k]["bound_ms"],
            "bound_by": demo_bound[k]["bound_by"], "library_ms": None,
            **by_run, "shapes": shapes,
        })
    # the draws' kernels: top-level times those of a frame512 tile's
    # draws (the SSS stage's purpose columns for rls_rng_sobol_at, which
    # the tile does not launch)
    for k, row in rngrun["kernels"].items():
        top = (row["tile"] if row["tile"]["launches"]
               else row["shapes"]["sobol2_at_columns"])
        by_run = run_launches(k)
        entries.append({
            "name": k, "route": "cuda", "source": RNG_SOURCE,
            "replaces": RNG_KERNELS[k],
            "launches": sum(by_run.values()),
            "mismatches": row["mismatches"],
            "max_abs_err": row["max_abs_err"],
            "ms": top["call_ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": ("bytes" if top["byte_ms"] >= top["op_ms"]
                         else "operations"), "library_ms": None,
            **by_run, "shapes": row["shapes"],
        })
    # the lobes' kernels: top-level times those of the kernel's largest
    # call (the frame512 frame's, the glass family's for sample_refract)
    for k, row in lobes["kernels"].items():
        top = max(row["shapes"].values(), key=lambda r: r["lanes"])
        by_run = run_launches(k)
        entries.append({
            "name": k, "route": "cuda", "source": LOBE_SOURCE,
            "replaces": LOBE_KERNELS[k],
            "launches": sum(by_run.values()),
            "mismatches": row["differ"], "max_ulps": row["max_ulps"],
            "ms": top["call_ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            **by_run, "shapes": row["shapes"],
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
