"""The data chain (counterpart of unet_convlstm_tpu/datagen/): LES
netCDF → patches → satellite radiance views and velocity maps → training
sequences.

* ``microphysics``  — cloud microphysics → optical extinction β (stage A
                      physics), on numpy arrays or torch tensors.
* ``lespatch``      — BOMEX LES netCDF → overlapping volume patches (stage
                      A; host numpy, netCDF4 or h5py to read the files).
* ``vol_format``    — Mitsuba ``VOL`` v3 binary grid writer/reader.
* ``renderer``      — the deterministic renderer (single scattering,
                      successive orders, shear-warp sun and camera paths).
* ``mc_reference``  — the Monte-Carlo path tracer (delta tracking, HG
                      sampling, sun NEE) with its two sampler routes: the
                      threefry chain (bit-equal uniforms to JAX's) and the
                      fused sampling kernel.
* ``render_batch``  — the ``gen-renders`` driver (stage B, serial and
                      batched).
* ``render_shard``  — a chunk of patches rendered as one batched program.
* ``raycast``       — first-hit and z-slice velocity-map ray casting on the
                      device (stage C).
* ``velocity_maps`` — the ``gen-maps`` driver (stage C, serial and
                      batched).
* ``sequences``     — renders + maps → training npz (stage D,
                      ``gen-sequences``).
* ``alignment``     — multi-view homography alignment to a virtual camera.
* ``overpass``      — the overpass CSV and its camera/sun geometry.

``train/cloud_gate.py`` drives the chain end to end (``cloud-gate``).
"""
