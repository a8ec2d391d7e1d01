"""Serving-side text encoding of the port (copies of vqa_tpu.datasets code that
import neither yaml nor h5py)."""
