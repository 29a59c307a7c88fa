"""Figures and videos (counterpart of unet_convlstm_tpu/viz/; geometry,
figures and rollout_video so far). matplotlib and cv2 are imported here
only, never by ``eval/``."""
