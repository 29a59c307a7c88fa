"""Probe scripts: small timed runs of one kernel each against the library
(counterparts of the JAX package's scripts/perf/bn_kernel_proto.py and
scripts/perf/probe_pallas_gather.py). Each runs as ``python -m
unet_convlstm_tpu_torch.probes.<name> [--device cpu]``."""
