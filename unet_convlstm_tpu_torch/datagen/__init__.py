"""Stage B of the data chain (counterpart of unet_convlstm_tpu/datagen/):
LES β patches → satellite radiance views.

* ``renderer``     — the deterministic renderer (single scattering,
                     successive orders, shear-warp sun and camera paths).
* ``mc_reference`` — the Monte-Carlo path tracer (delta tracking, HG
                     sampling, sun NEE) with its two sampler routes: the
                     threefry chain (bit-equal uniforms to JAX's) and the
                     fused sampling kernel.
* ``render_batch`` — the ``gen-renders`` driver (serial and batched).
* ``render_shard`` — a chunk of patches rendered as one batched program.
* ``overpass``     — the overpass CSV and its camera/sun geometry.

Stages A (patches), C (velocity maps) and D (sequences) are not ported yet
(ROADMAP.md queue A).
"""
