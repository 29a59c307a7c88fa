"""Examples of the port as a library (counterparts of the repo's
examples/*.py). Each runs as ``python -m
unet_convlstm_tpu_torch.examples.<name>`` on the card, or with ``--device
cpu`` on the CPU, and has ``main(argv=None) -> int``:

* ``library_quickstart``: Moving-MNIST → ``fit`` → the best checkpoint →
  ``evaluate_model`` → ``rollout_streaming``, ending with QUICKSTART_OK;
* ``render_one``: one volume rendered from every satellite of an overpass,
  warped into a virtual nadir camera; figures where matplotlib is
  installed.
"""
